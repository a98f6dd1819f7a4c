"""The machinery the A/B scripts at the root of the checkout share
(``flash_ab.py``, ``conv_ab.py``): they time kernels against variants of
their own CUDA sources, in one process on one card.

A variant is a copy of some sources of ``mxnet_tpu_torch/csrc/`` with text
replaced below the first ``namespace sm90 {`` of a file, or another anchor
(the kernels' code, not the note above it); a replacement whose text is
not there stops the run before anything is built. The copies are written to
``build/<tool>/<variant>/`` and built by the package's own ``_build`` from
there (``csrc=``: the same flags, one ``nvcc`` per distinct library, all
started together); the package's wrappers are not touched. The variants
are then timed in turns, the order forward and back, so a drift of the
card's clocks falls on all of them alike.
"""
from __future__ import annotations

import shutil
import statistics
from concurrent.futures import ThreadPoolExecutor

from ..ops import _build


def write_variants(root, sources, variants, anchor="namespace sm90 {"):
    """Write every variant's copy of ``sources`` (file names in
    ``_build.CSRC``) under ``root``, emptied first; ``variants`` maps a name
    to its edits, ``[(file, old text, new text)]``, each applied below the
    first ``anchor`` of its file. Returns {name: directory}."""
    shutil.rmtree(root, ignore_errors=True)
    dirs = {}
    for name, edits in variants.items():
        texts = {f: (_build.CSRC / f).read_text() for f in sources}
        for f, old, new in edits:
            head, sep, body = texts[f].partition(anchor)
            if old not in body:
                raise SystemExit("variant %s: %r not found in %s" % (name, old, f))
            texts[f] = head + sep + body.replace(old, new)
        dirs[name] = root / name
        dirs[name].mkdir(parents=True)
        for f, text in texts.items():
            (dirs[name] / f).write_text(text)
    return dirs


def build_variants(dirs, kernels):
    """Build the libraries of ``kernels`` for every variant directory, one
    build per distinct library (a variant that leaves a source as it is
    shares its library), all started together. Returns {name: [entry point
    of each kernel]}."""
    jobs = {}
    for d in dirs.values():
        for k in kernels:
            jobs.setdefault(_build.library_path(k, d), (k, d))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build([job[0]], job[1]), jobs.values()))
    return {name: [_build.load(k, d) for k in kernels] for name, d in dirs.items()}


def registers(dirs, kernels, parse):
    """{name: {kernel label: ptxas line}} of every variant's Hopper kernels
    (labels holding ``_sm90<``), read from its libraries' build logs by
    ``parse`` (``chip_smoke.ptxas_lines``)."""
    return {name: {label: line for k in kernels for label, line in parse(
                       _build.library_path(k, d).with_suffix(".log").read_text()).items()
                   if "_sm90<" in label}
            for name, d in dirs.items()}


def in_turns(names, rounds, time_variant):
    """Time every variant ``rounds`` times in turns, the order forward and
    back; ``time_variant(name)`` returns {key: ms}. Returns {name: {key:
    [ms, ...]}} and the medians, {name: {key: ms}}."""
    ms = {name: {} for name in names}
    for _ in range(rounds):
        for name in list(names) + list(names)[::-1]:
            for key, t in time_variant(name).items():
                ms[name].setdefault(key, []).append(t)
    return ms, {name: {k: statistics.median(v) for k, v in r.items()} for name, r in ms.items()}

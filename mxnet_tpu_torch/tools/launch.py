"""Start a job of N worker processes (counterpart of the repo's
``tools/launch.py``, the reference's dmlc tracker).

There is no scheduler or server tier: a job is N identical worker
processes that join one ``torch.distributed`` gloo group
(``parallel.mesh.init_distributed``, which a dist kvstore calls when it is
created) and talk only through its collectives. Every worker gets the
reference's names ``DMLC_ROLE=worker``, ``DMLC_RANK``, ``DMLC_NUM_WORKER``,
``DMLC_NUM_SERVER=0`` and ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT``, the
group's rendezvous ``MXTPU_COORDINATOR_ADDRESS`` (host:port) and the
liveness directory ``MXTPU_RUN_DIR`` (``parallel/heartbeat.py``).

- ``local`` (the default): N processes on this host, each the leader of its
  own process group. The port is a free one unless ``--port`` names it.
  The workers' gloo traffic goes over loopback (``GLOO_SOCKET_IFNAME=lo``
  unless it is set). When a worker exits with a code other than 0 the others' groups are
  killed (SIGTERM, then SIGKILL after a grace) and the launcher returns
  that worker's code, so a rank that failed before a collective never
  leaves its peer waiting there; SIGINT / SIGTERM to the launcher kill
  every worker's group.
- ``ssh``: one ssh command a host of the hostfile, with the same
  environment.
- ``mpi`` / ``sge`` / ``yarn``: a wrapper script that maps the scheduler's
  rank variable onto that environment, submitted through ``mpirun`` /
  ``qsub`` / ``yarn``, or printed with ``--dry-run`` (or when the tool is
  not on PATH).

``-n`` defaults to ``MXTPU_WORLD_SIZE`` (which ``tools/watchdog.py
--elastic`` sets for each attempt). Usage::

    python -m mxnet_tpu_torch.tools.launch -n 2 python train.py --kv-store dist_sync
    python -m mxnet_tpu_torch.tools.launch -n 2 -H hosts.txt --launcher ssh python train.py
"""
from __future__ import annotations

import argparse
import os
import shlex
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

#: Seconds between SIGTERM and SIGKILL when the launcher kills its workers.
KILL_GRACE = 10.0


def free_port(host="127.0.0.1"):
    """A port the OS reports free (bound to port 0, then released)."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


def worker_env(rank, num_workers, coordinator, run_dir=None, base=None):
    """The environment of worker ``rank`` of ``num_workers``: ``base``
    (default ``os.environ``) plus the DMLC and MXTPU names."""
    env = dict(os.environ if base is None else base)
    if run_dir:
        env["MXTPU_RUN_DIR"] = run_dir
    host, _, port = coordinator.rpartition(":")
    env.update({
        "MXTPU_COORDINATOR_ADDRESS": coordinator,
        "DMLC_ROLE": "worker",
        "DMLC_RANK": str(rank),
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_NUM_SERVER": "0",  # no server tier
        "DMLC_PS_ROOT_URI": host,
        "DMLC_PS_ROOT_PORT": port,
    })
    return env


def _kill_group(proc, sig):
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        if proc.poll() is None:
            try:
                proc.send_signal(sig)
            except ProcessLookupError:
                pass


def _kill_all(procs, grace=KILL_GRACE):
    """SIGTERM every live worker's process group, SIGKILL what is left
    after ``grace`` seconds, and reap them all."""
    for p in procs:
        if p.poll() is None:
            _kill_group(p, signal.SIGTERM)
    deadline = time.time() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            _kill_group(p, signal.SIGKILL)
            p.wait()
    for p in procs:  # a worker's children may outlive it in its group
        _kill_group(p, signal.SIGKILL)


def _code(rc):
    """A worker's exit code as a shell reports it (128 + signal)."""
    return 128 - rc if rc < 0 else rc


def launch_local(num_workers, command, coordinator_port=0, grace=KILL_GRACE, poll=0.05):
    """Run ``command`` as ``num_workers`` local workers; returns 0 when all
    exit 0, else the code of the first worker that failed (the others are
    killed then)."""
    port = coordinator_port or free_port()
    coordinator = "127.0.0.1:%d" % port
    # a supervisor's liveness dir (tools/watchdog.py polls it) is kept;
    # standalone, the launcher makes its own and removes it at the end
    run_dir = os.environ.get("MXTPU_RUN_DIR")
    own_run_dir = None
    if not run_dir:
        run_dir = own_run_dir = tempfile.mkdtemp(prefix="mxtpu_run_")
    procs = []
    stop = {"sig": None}

    def _on_signal(signum, frame):
        stop["sig"] = signum

    prev = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prev[sig] = signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread: the caller's handlers stay
    rc = 0
    try:
        for rank in range(num_workers):
            env = worker_env(rank, num_workers, coordinator, run_dir)
            # the workers of one host talk over loopback, whatever the
            # host's name resolves to
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            procs.append(subprocess.Popen(command, env=env, start_new_session=True))
        while True:
            if stop["sig"] is not None:
                _kill_all(procs, grace)
                rc = 1
                break
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                rc = _code(failed[0])
                _kill_all(procs, grace)
                break
            if all(c == 0 for c in codes):
                break
            time.sleep(poll)
    finally:
        if any(p.poll() is None for p in procs):
            _kill_all(procs, grace)
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        if own_run_dir:
            shutil.rmtree(own_run_dir, ignore_errors=True)
    return rc


def ssh_commands(hosts, num_workers, command, coordinator_port=29500, cwd=None):
    """One ``ssh`` argv a worker (workers round-robin over ``hosts``)."""
    coordinator = "%s:%d" % (hosts[0], coordinator_port)
    cmds = []
    for rank in range(num_workers):
        env = worker_env(rank, num_workers, coordinator, os.environ.get("MXTPU_RUN_DIR"),
                         base={})
        exports = " ".join("%s=%s" % (k, shlex.quote(v)) for k, v in sorted(env.items()))
        remote = "cd %s && env %s %s" % (shlex.quote(cwd or os.getcwd()), exports,
                                         " ".join(shlex.quote(c) for c in command))
        cmds.append(["ssh", "-o", "StrictHostKeyChecking=no", hosts[rank % len(hosts)],
                     remote])
    return cmds


def launch_ssh(hosts, num_workers, command, coordinator_port=29500, dry_run=False):
    cmds = ssh_commands(hosts, num_workers, command, coordinator_port)
    if dry_run:
        for cmd in cmds:
            print(" ".join(cmd))
        return 0
    procs = [subprocess.Popen(cmd) for cmd in cmds]
    rc = 0
    for p in procs:
        rc = rc or _code(p.wait())
    return rc


RANK_SHIM = r"""#!/bin/sh
# written by mxnet_tpu_torch.tools.launch: the scheduler's rank variable
# becomes the DMLC / MXTPU environment of a worker, then the command runs
RANK="${OMPI_COMM_WORLD_RANK:-${PMI_RANK:-${PMIX_RANK:-${SLURM_PROCID:-0}}}}"
if [ -n "$SGE_TASK_ID" ]; then RANK=$(($SGE_TASK_ID - 1)); fi
export MXTPU_COORDINATOR_ADDRESS="%(coord)s"
export DMLC_ROLE=worker
export DMLC_RANK="$RANK"
export DMLC_NUM_WORKER="%(n)d"
export DMLC_NUM_SERVER=0
export DMLC_PS_ROOT_URI="%(host)s"
export DMLC_PS_ROOT_PORT="%(port)s"
exec %(cmd)s
"""


def rank_shim(num_workers, coordinator, command):
    """The text of the wrapper script that mpi / sge / yarn tasks run."""
    host, _, port = coordinator.rpartition(":")
    return RANK_SHIM % {"n": num_workers, "coord": coordinator, "host": host, "port": port,
                        "cmd": " ".join(shlex.quote(c) for c in command)}


def _write_rank_shim(num_workers, coordinator, command, directory=None):
    """The shim in ``directory`` (the job's cwd by default: tasks on other
    hosts see it over the shared filesystem, never this node's /tmp)."""
    fd, path = tempfile.mkstemp(prefix="mxtpu_launch_", suffix=".sh",
                                dir=directory or os.getcwd())
    with os.fdopen(fd, "w") as f:
        f.write(rank_shim(num_workers, coordinator, command))
    os.chmod(path, 0o755)
    return path


def _submit(cmd, tool, dry_run):
    """Print (dry run, or the tool missing) or run a submission command."""
    if dry_run or shutil.which(tool) is None:
        print(" ".join(cmd))
        if shutil.which(tool) is None and not dry_run:
            print("%s not on PATH; dry-run output above" % tool, file=sys.stderr)
            return 127
        return 0
    return subprocess.call(cmd)


def _coord_host(default):
    return os.environ.get("MXTPU_COORD_HOST", default)


def mpi_command(num_workers, shim):
    tool = ("mpirun" if shutil.which("mpirun") else
            "mpiexec" if shutil.which("mpiexec") else "mpirun")
    return [tool, "-np", str(num_workers), shim]


def sge_command(num_workers, shim, queue=None):
    cmd = ["qsub", "-terse", "-cwd", "-V", "-b", "y", "-t", "1-%d" % num_workers]
    if queue:
        cmd += ["-q", queue]
    return cmd + [shim]


def yarn_command(num_workers, shim):
    # CONTAINER_ID = container_<cluster>_<app>_<attempt>_<ordinal>; ordinal 1
    # is the application master, workers start at 2; ordinals are
    # zero-padded, so strip the padding before the shell's arithmetic
    shell = ("ORD=${CONTAINER_ID##*_}; ORD=${ORD#${ORD%%[!0]*}}; ORD=${ORD:-0}; "
             "OMPI_COMM_WORLD_RANK=$((ORD - 2)) sh %s" % shim)
    jar = os.environ.get("YARN_DSHELL_JAR", "hadoop-yarn-applications-distributedshell.jar")
    return ["yarn", "jar", jar, "-jar", jar, "-num_containers", str(num_workers),
            "-shell_command", shell]


def launch_mpi(num_workers, command, coordinator_port=29500, dry_run=False):
    coordinator = "%s:%d" % (_coord_host("127.0.0.1"), coordinator_port)
    shim = _write_rank_shim(num_workers, coordinator, command)
    cmd = mpi_command(num_workers, shim)
    return _submit(cmd, cmd[0], dry_run)


def launch_sge(num_workers, command, coordinator_port=29500, dry_run=False, queue=None):
    coordinator = "%s:%d" % (_coord_host(socket.gethostname()), coordinator_port)
    shim = _write_rank_shim(num_workers, coordinator, command)
    return _submit(sge_command(num_workers, shim, queue), "qsub", dry_run)


def launch_yarn(num_workers, command, coordinator_port=29500, dry_run=False):
    coordinator = "%s:%d" % (_coord_host(socket.gethostname()), coordinator_port)
    shim = _write_rank_shim(num_workers, coordinator, command)
    return _submit(yarn_command(num_workers, shim), "yarn", dry_run)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", "--num-workers", type=int, default=None,
                   help="workers (default: MXTPU_WORLD_SIZE)")
    p.add_argument("-H", "--hostfile", default=None)
    p.add_argument("--launcher", default="local",
                   choices=["local", "ssh", "mpi", "sge", "yarn"])
    p.add_argument("--port", type=int, default=0, help="rendezvous port (0: a free one)")
    p.add_argument("--queue", default=None, help="sge queue (-q)")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        p.error("no command given")
    n = args.num_workers
    if n is None:
        try:
            n = int(os.environ.get("MXTPU_WORLD_SIZE", ""))
        except ValueError:
            p.error("-n not given and MXTPU_WORLD_SIZE unset")
    if args.launcher == "local":
        return launch_local(n, command, args.port)
    port = args.port or 29500
    if args.launcher == "mpi":
        return launch_mpi(n, command, port, dry_run=args.dry_run)
    if args.launcher == "sge":
        return launch_sge(n, command, port, dry_run=args.dry_run, queue=args.queue)
    if args.launcher == "yarn":
        return launch_yarn(n, command, port, dry_run=args.dry_run)
    if not args.hostfile:
        p.error("--launcher ssh needs -H hostfile")
    with open(args.hostfile) as f:
        hosts = [line.strip() for line in f if line.strip()]
    return launch_ssh(hosts, n, command, port, dry_run=args.dry_run)


if __name__ == "__main__":
    sys.exit(main())

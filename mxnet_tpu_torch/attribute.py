"""Attribute scoping for symbols (a copy of ``mxnet_tpu/attribute.py``).

Parity: reference ``python/mxnet/attribute.py`` (AttrScope). Carries
``ctx_group`` / ``__force_mirroring__`` / arbitrary attrs onto symbols
created inside the scope.
"""
from __future__ import annotations

import threading


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes need to be strings")
        self._attr = kwargs

    def get(self, attr):
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, *args):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        if not hasattr(AttrScope._current, "value") or AttrScope._current.value is None:
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value

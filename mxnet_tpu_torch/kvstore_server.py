"""KVStore server bootstrap (counterpart of ``mxnet_tpu/kvstore_server.py``,
the reference's ``python/mxnet/kvstore_server.py``).

In the reference a process whose ``DMLC_ROLE`` is ``server`` or
``scheduler`` blocks inside ``import mxnet`` running a ps-lite server loop,
and the rank-0 worker ships it a pickled Optimizer (command 0). The port
has no server tier: the workers sum their gradients in the gloo group's
collectives (``parallel/mesh.py``) and run the optimizer themselves. This
module gives launchers that still start servers a logged no-op
(:func:`_init_kvstore_server_module`) and keeps the controller's command
protocol (command 0 = a pickled optimizer) testable.
"""
from __future__ import annotations

import logging
import os
import pickle


class KVStoreServer:
    """The command loop of a reference server process
    (``kvstore_server.py:24``)."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.handlers = {}
        self._running = False

    def _controller(self, cmd_id, cmd_body):
        """Command 0 installs the pickled optimizer as the store's updater;
        other commands go to their handler (``kvstore_server.py:35``)."""
        if cmd_id == 0:
            self.kvstore.set_optimizer(pickle.loads(cmd_body))
        else:
            handler = self.handlers.get(cmd_id)
            if handler is None:
                logging.warning("server got unknown command %d", cmd_id)
            else:
                handler(cmd_body)

    def run(self, commands=()):
        """Process the given controller commands and return (the reference
        blocks on ZMQ; here there is nothing to wait for)."""
        self._running = True
        for cmd_id, cmd_body in commands:
            self._controller(cmd_id, cmd_body)
        self._running = False


def _init_kvstore_server_module():
    """The role of this process (``kvstore_server.py:58``): a ``server`` or
    ``scheduler`` role is logged as a no-op and returns at once."""
    role = os.environ.get("DMLC_ROLE", "worker")
    if role in ("server", "scheduler"):
        logging.info("DMLC_ROLE=%s: the port has no parameter-server tier (gradients are "
                     "summed in the workers' gloo collectives); the role is a no-op.", role)
    return role

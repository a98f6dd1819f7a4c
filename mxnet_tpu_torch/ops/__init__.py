"""Operators of the PyTorch port. ``registry`` holds the ``OpDef`` table;
``elemwise``, ``broadcast_reduce``, ``matrix``, ``init_ops``, ``indexing``,
``sample``, ``optimizer_ops``, ``nn`` and ``rnn_op`` register the ported operators
(importing ``symbol`` or ``ndarray`` imports them). ``kernels`` holds the
hand-written CUDA kernels' wrappers and their plain versions; ``_build``
compiles the CUDA sources at first use (importing this package builds
nothing)."""

"""Command-line tools of the port: the apps' drivers (``python -m
sigma_tpu_torch.tools.ising``, ``... .self_avoiding_walk``), the kernel
comparison scripts (run by path), the distributed dry run and ``entry()``
(``tools/entry.py``, the counterpart of ``__graft_entry__.entry()``)."""

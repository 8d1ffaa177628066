"""Command-line tools of the port: the apps' drivers (``python -m
sigma_tpu_torch.tools.ising``, ``... .self_avoiding_walk``) and the
kernel comparison scripts (run by path)."""

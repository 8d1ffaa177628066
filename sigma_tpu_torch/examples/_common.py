"""The command line every example script takes: ``--device`` (default
CUDA) and whatever the script adds."""

from __future__ import annotations

import argparse


def cli(doc: str, add=None, argv=None) -> dict:
    """The keyword arguments of an example's ``main`` from its command
    line: ``--device`` and whatever ``add(parser)`` declares."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    if add is not None:
        add(ap)
    return vars(ap.parse_args(argv))

"""Measurement entry points of the PyTorch port, and the argument handling
they share: each runs on the card unless `--device cpu` is given, and
takes the CLI's `--set model.K=V` / `train.K=V` config overrides."""

from __future__ import annotations

import argparse


def entry_parser(description: str) -> argparse.ArgumentParser:
    """An entry point's parser with --device and --set."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config override, model.K=V or train.K=V (values "
                         "parsed as JSON)")
    return ap


def with_sets(exp, sets):
    """`exp` with the --set pairs applied (cli.parse_overrides)."""
    from ..cli import parse_overrides
    from ..configs import with_overrides

    return with_overrides(exp, parse_overrides(sets or []))


def device_line(device) -> str:
    """What a result ran on: `nvidia-smi`'s name and power limit of the
    card, or "cpu"."""
    from .doctor import smi_line

    return smi_line() if device.type == "cuda" else "cpu"

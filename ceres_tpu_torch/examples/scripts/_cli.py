"""The flag every example program of the port adds: `--device`."""

from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with `--device` (None: the card)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None,
                    help="torch device to run on, e.g. cpu or cuda:0 (default: the card)")
    return ap

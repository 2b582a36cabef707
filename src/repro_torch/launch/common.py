"""Shared CLI surface for the launch entry points.

The entry points drive the same substrate (corpus generation, the
heterogeneity profile, the switching policy, the kernel data plane and
its autotune winner cache, the device), so the flags that select it are
declared once here and attached by each entry point: a flag added here
shows up everywhere with the same name, default and help text.

Each ``add_*`` helper attaches one coherent flag group to an existing
parser; ``standard_parser()`` builds a parser with all of them for the
entry points that want the full set.
"""
from __future__ import annotations

import argparse

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.runtime import POLICY_NAMES

# Named core profiles every CLI's --profile resolves through (paper §IV:
# one fast core + progressively slower ones; the alternatives isolate the
# scheduler's contribution).
PROFILES = {
    "paper": HeterogeneityProfile.paper,
    "homogeneous": lambda: HeterogeneityProfile.homogeneous(4, 200.0),
    "straggler": lambda: HeterogeneityProfile.straggler(8, 2, 4.0),
}


def add_corpus_args(ap: argparse.ArgumentParser, n_tx: int = 8192,
                    n_items: int = 128, min_support: float = 0.02,
                    min_confidence: float = 0.6) -> argparse.ArgumentParser:
    """Synthetic-corpus shape and mining thresholds."""
    ap.add_argument("--n-tx", type=int, default=n_tx)
    ap.add_argument("--n-items", type=int, default=n_items)
    ap.add_argument("--min-support", type=float, default=min_support)
    ap.add_argument("--min-confidence", type=float, default=min_confidence)
    return ap


def add_runtime_args(ap: argparse.ArgumentParser,
                     policy: str = "static",
                     split: str = "lpt") -> argparse.ArgumentParser:
    """Heterogeneity profile + switching policy + tile split."""
    ap.add_argument("--profile", default="paper", choices=sorted(PROFILES))
    ap.add_argument("--policy", default=policy, choices=list(POLICY_NAMES),
                    help="switching policy: plan once (static), closed-loop "
                         "EWMA + speculation (dynamic), roofline-seeded "
                         "costs (costmodel)")
    ap.add_argument("--split", default=split,
                    choices=["lpt", "proportional", "equal"],
                    help="tile split strategy across the core profile")
    return ap


def add_dataplane_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Kernel backend, autotune winner cache, and the device counting and
    scoring run on."""
    ap.add_argument("--data-plane", default="auto",
                    choices=["auto", "cuda", "ref"],
                    help="the CUDA kernels (cuda), their plain PyTorch "
                         "versions (ref), or whichever the device runs "
                         "(auto)")
    ap.add_argument("--autotune", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="use the checked-in kernel winner cache for "
                         "variant selection and, under --policy costmodel, "
                         "its measured rates (--no-autotune = "
                         "roofline-seeded defaults)")
    ap.add_argument("--device", default="cuda",
                    help="where counting and scoring run (default: cuda)")
    return ap


def add_seed_arg(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--seed", type=int, default=0)
    return ap


def standard_parser(**corpus_defaults) -> argparse.ArgumentParser:
    """Parser with the full shared flag set (corpus, runtime, data plane,
    seed); entry points add their own flags on top."""
    ap = argparse.ArgumentParser()
    add_corpus_args(ap, **corpus_defaults)
    add_runtime_args(ap)
    add_dataplane_args(ap)
    add_seed_arg(ap)
    return ap

"""The block-column law of chip_smoke.py's sparse matrix S, on the CPU.

    PYTHONPATH=src python3 tools/sparse_spectrum.py [--rows 16384]

Draws S's block pattern (chip_smoke.sparse_columns) for a sample of
block-rows and prints each block column's share of the block-rows, the
largest and smallest.  A Gaussian block column j that sits in a share c_j
of the block-rows gives SᵀS about c_j·m on its diagonal, so the
shares are S's spectrum up to scale.  From them it prints the relative
gradient ||Sᵀ(Sx − b)|| / ||Sᵀb|| that k gradient steps at L = σ₁² leave
when started from 0 (each mode keeps (1 − λ/L)^k of its part of Sᵀb),
ignoring the noise and the couplings between block columns: the prediction
behind chip_smoke.py's REL_GRAD_LIMIT.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 14,
                    help="block-rows sampled (S has M_S / BS_S)")
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 3)
    cols = chip_smoke.sparse_columns(args.rows, gen, torch.device("cpu"))
    nbc = chip_smoke.N_S // chip_smoke.BS_S
    share = torch.bincount(cols.flatten().long(), minlength=nbc).double()
    share /= args.rows
    top = share.sort(descending=True).values
    print(f"block-column shares of {args.rows} block-rows: largest "
          f"{top[:4].tolist()}, median {float(share.median()):.4f}, "
          f"smallest {float(top[-1]):.4f}")
    lam = share / share.max()
    for k in (100, 200, chip_smoke.SPARSE_ITERS, 600):
        r = torch.sqrt((lam ** 2 * (1 - lam) ** (2 * k)).sum()
                       / (lam ** 2).sum())
        print(f"relative gradient after {k} steps: {float(r):.3e}")


if __name__ == "__main__":
    main()

"""Tutorials 2a/2b on PyTorch: vertical (split-NN) FL and generative FL with
TSTR.  The counterpart of ``examples/vfl_and_generative_fl.py``.

- VFL (``lab/tutorial_2b/vfl.py:104-157``): 4 parties each own a disjoint
  feature slice of the heart-disease table; per-party bottom models feed a
  server top model through the explicit cut layer; joint AdamW training;
- generative FL (``lab/tutorial_2a/generative-modeling.py:129-208``): a
  tabular VAE learns the joint (features, label) distribution, synthesizes
  a dataset, and the Train-on-Synthetic-Test-on-Real harness compares
  evaluator accuracy on real vs synthetic training data.

Run: ``python -m ddl25spring_tpu_torch.examples.vfl_and_generative_fl
[--epochs 300] [--vae-epochs 150] [--device cpu]``.  Returns (and prints)
the VFL test accuracy and TSTR's two accuracies.
"""

from __future__ import annotations

import argparse

import numpy as np

from ddl25spring_tpu_torch.data.heart import load_heart, partition_features
from ddl25spring_tpu_torch.fl.generative import TabularVAE, tstr
from ddl25spring_tpu_torch.fl.vertical import VFLNetwork


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=300)  # vfl.py:153
    ap.add_argument("--vae-epochs", type=int, default=150)
    ap.add_argument("--parties", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=42)  # vfl.py:106
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = load_heart(seed=args.seed)
    x, y = data["x"], data["y"]
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(len(x))
    split = int(0.8 * len(x))
    tr, te = perm[:split], perm[split:]

    print(f"== VFL: {args.parties} parties, {args.epochs} epochs ({data['provenance']} data) ==")
    feats = partition_features(data["feature_slices"], args.parties)
    net = VFLNetwork(feats, seed=args.seed, device=args.device)
    losses = net.train_with_settings(args.epochs, args.batch, x[tr], y[tr])
    acc, _ = net.test(x[te], y[te])
    print(f"VFL: train loss {losses[-1]:.4f} -> test acc {acc:.4f}")

    print(f"\n== Generative FL: VAE ({args.vae_epochs} epochs) + TSTR ==")
    real = np.concatenate([x[tr], y[tr, None].astype(np.float32)], axis=1)
    vae = TabularVAE(d_in=real.shape[1], seed=args.seed, device=args.device)
    vae_losses = vae.train_with_settings(args.vae_epochs, args.batch, real)
    result = tstr(vae, x[tr], y[tr], x[te], y[te], seed=args.seed)
    print(f"TSTR: train-on-real acc {result['real']:.4f}, "
          f"train-on-synthetic acc {result['synthetic']:.4f}")
    return {"vfl_acc": acc, "vfl_losses": losses, "vae_losses": vae_losses,
            "tstr_real": result["real"], "tstr_synthetic": result["synthetic"],
            "provenance": data["provenance"]}


if __name__ == "__main__":
    main()

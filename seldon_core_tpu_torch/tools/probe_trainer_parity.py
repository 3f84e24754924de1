"""Phase 28d's trainer comparison, entry by entry.

    python -m seldon_core_tpu_torch.tools.probe_trainer_parity [--steps 3]

Run from the repository root on a CUDA card (it uses ``chip_smoke.py``'s
28d constants).  Trains ResNet-50 (1000 classes, batch 32 of 224x224x3
ImageNet-normalised images, float32, TF32 off, cuDNN deterministic) from
one seeded initialisation on a ``{"data": 2}`` mesh of two ``cuda:0``
positions and on one position, as 28d does.  After each step it prints,
for rules that exempt a parameter entry by the size of the one-position
trainer's gradient (absolute, or relative to its leaf's largest
gradient entry), the share of entries held and how far the held entries'
parameters differ between the two trainers, relative to their leaf's
largest entry.  An entry is exempt under ``step1`` when its first-step
gradient is below the rule's size, under ``any`` when its gradient at any
step so far is.  Prints the card's name and power limit, and everything
as one JSON object on the last line.

With ``--sync`` each step starts both trainers from the same state: the
one-position trainer's parameters and AdamW moments are copied into the
mesh trainer first, so a step's differences are that step's alone.  An
entry is then exempt under a rule ``rel<a,abs<b`` when its one-position
gradient at that step is nonzero and below ``a`` of its leaf's largest
gradient entry or below ``b``; the worst held entries are listed.

``--device cpu --image 32 --batch 4`` runs the same comparison on the
CPU at a small size (no timing is read from it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ABS_RULES = (1e-9, 1e-8, 1e-7, 1e-6)
REL_RULES = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3)
RATIOS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3)
SYNC_RULES = [(a, b) for a in (0.0, 1e-4, 1e-3, 1e-2) for b in (0.0, 1e-8, 1e-7, 1e-6, 1e-5)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--image", type=int, default=224)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--sync", action="store_true", help="start each step from the same state")
    parser.add_argument("--out", default="", help="also write the whole result as JSON to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from seldon_core_tpu_torch.models import resnet
    from seldon_core_tpu_torch.ops import kernels
    from seldon_core_tpu_torch.parallel import ShardedTrainer, create_mesh

    card = "cpu"
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    img = (args.image, args.image, 3)
    rng = np.random.default_rng(cs.SEED + 284)
    images = rng.integers(0, 256, (args.batch, *img), dtype=np.uint8)
    labels = rng.integers(0, cs.NUM_CLASSES, args.batch)
    scale, shift = kernels.imagenet_affine()
    x = images.astype(np.float32) * scale + shift
    init = resnet.ResNet50(num_classes=cs.NUM_CLASSES, dtype=torch.float32).reset_parameters(
        torch.Generator().manual_seed(cs.SEED + 285)).state_dict()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainers = {n: ShardedTrainer(resnet.ResNet50(num_classes=cs.NUM_CLASSES, dtype=torch.float32),
                                  np.zeros(img, np.float32), create_mesh({"data": n}, devices=[dev] * n),
                                  params=init) for n in (2, 1)}
    keys = list(trainers[1].params)
    total = sum(trainers[1].params[k].shape.numel() for k in keys)
    rules = [("abs", t) for t in ABS_RULES] + [("rel", t) for t in REL_RULES]
    first_g, small_any = {}, {r: {} for r in rules}
    steps, losses = [], {2: [], 1: []}
    if args.sync:
        return _write(args.out, _sync_steps(torch, np, trainers, keys, total, x, labels, args.steps, dev, card))
    for step in range(args.steps):
        for n, t in trainers.items():
            losses[n].append(t.train_batch(x, labels)["loss"])
        grads = trainers[1].grads
        for k in keys:
            g = grads[k].abs()
            gmax = float(g.max())
            if step == 0:
                first_g[k] = (g.clone(), gmax)
            for kind, tau in rules:
                small = g < (tau if kind == "abs" else tau * gmax)
                prev = small_any[(kind, tau)].get(k)
                small_any[(kind, tau)][k] = small if prev is None else prev | small
        a_state, b_state = trainers[2].params, trainers[1].params
        ratio = {}
        for k in keys:
            a, b = a_state[k].full(dev), b_state[k].full(dev)
            ratio[k] = (a - b).abs() / max(float(b.abs().max()), 1e-12)
        row = {"step": step + 1, "loss_2": losses[2][-1], "loss_1": losses[1][-1],
               "all": _summary(torch, ratio, None, keys, total), "rules": {}}
        for kind, tau in rules:
            held1 = {k: ~(first_g[k][0] < (tau if kind == "abs" else tau * first_g[k][1])) for k in keys}
            held_any = {k: ~small_any[(kind, tau)][k] for k in keys}
            row["rules"][f"{kind}<{tau:g}"] = {"step1": _summary(torch, ratio, held1, keys, total),
                                               "any": _summary(torch, ratio, held_any, keys, total)}
        steps.append(row)
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return _write(args.out, {"card": card, "entries": total, "steps": steps})


def _write(path: str, result) -> int:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


def _sync_steps(torch, np, trainers, keys, total, x, labels, steps, dev, card):
    """Each step from the one-position trainer's state; a third trainer,
    one position fed the batch's rows in reverse order (the same sums in
    another order), measures float32's own noise beside the mesh's."""
    import chip_smoke as cs
    from seldon_core_tpu_torch.models import resnet
    from seldon_core_tpu_torch.parallel import ShardedTrainer, create_mesh

    rev = ShardedTrainer(resnet.ResNet50(num_classes=1000, dtype=torch.float32), np.zeros(x.shape[1:], np.float32),
                         create_mesh({"data": 1}, devices=[dev]), params=trainers[1].state_dict())
    rows, losses = [], {2: [], 1: []}
    for step in range(steps):
        cs.copy_trainer_state(trainers[2], trainers[1])
        cs.copy_trainer_state(rev, trainers[1])
        rev.train_batch(x[::-1].copy(), labels[::-1].copy())
        for n, t in trainers.items():
            losses[n].append(t.train_batch(x, labels)["loss"])
        rev_ratio = {}
        for k in keys:
            b = trainers[1].params[k].full(dev)
            rev_ratio[k] = (rev.params[k].full(dev) - b).abs() / max(float(b.abs().max()), 1e-12)
        reversed_rows = {"all": _summary(torch, rev_ratio, None, keys, total),
                         "grads": _grads({2: rev, 1: trainers[1]}, keys)}
        g = {k: trainers[1].grads[k].abs() for k in keys}
        gmax = {k: float(g[k].max()) for k in keys}
        ratio, pmax = {}, {}
        for k in keys:
            a, b = trainers[2].params[k].full(dev), trainers[1].params[k].full(dev)
            pmax[k] = max(float(b.abs().max()), 1e-12)
            ratio[k] = (a - b).abs() / pmax[k]
        row = {"step": step + 1, "loss_2": losses[2][-1], "loss_1": losses[1][-1],
               "all": _summary(torch, ratio, None, keys, total), "rules": {}, "grads": _grads(trainers, keys),
               "reversed_rows": reversed_rows}
        for a_rel, b_abs in SYNC_RULES:
            held = {k: ~((g[k] > 0) & ((g[k] < a_rel * gmax[k]) | (g[k] < b_abs))) for k in keys}
            row["rules"][f"rel<{a_rel:g},abs<{b_abs:g}"] = _summary(torch, ratio, held, keys, total)
        worst = []
        for k in keys:
            r = ratio[k].reshape(-1)
            top = torch.topk(r, min(3, r.numel()))
            for v, i in zip(top.values.tolist(), top.indices.tolist()):
                gi = float(g[k].reshape(-1)[i])
                worst.append({"leaf": k, "ratio": v, "g": gi, "g_rel": gi / max(gmax[k], 1e-30),
                              "leaf_max": pmax[k]})
        row["worst_entries"] = sorted(worst, key=lambda e: -e["ratio"])[:25]
        rows.append(row)
        print(json.dumps({k: row[k] for k in ("step", "loss_2", "loss_1", "all", "grads", "reversed_rows")}),
              flush=True)
    print(card, flush=True)
    return {"card": card, "entries": total, "sync": True, "steps": rows}


def _grads(trainers, keys):
    """The two trainers' gradients of one step: each leaf's relative L2
    difference (the worst leaves listed) and the entries within each of
    ``RATIOS`` of their leaf's largest gradient entry."""
    rel_l2, within = {}, [0] * len(RATIOS)
    for k in keys:
        a, b = trainers[2].grads[k].float(), trainers[1].grads[k].float()
        nb = float(b.norm())
        rel_l2[k] = float((a - b).norm()) / nb if nb > 0 else float((a - b).norm())
        d = (a - b).abs() / max(float(b.abs().max()), 1e-30)
        for i, lim in enumerate(RATIOS):
            within[i] += int((d <= lim).sum())
    worst = sorted(rel_l2.items(), key=lambda kv: -kv[1])[:10]
    return {"worst_rel_l2": worst, "entries_within": dict(zip((f"{v:g}" for v in RATIOS), within))}


def _summary(torch, ratio, held, keys, total):
    """Share of entries held, their worst ratio, and how many exceed each
    of ``RATIOS``."""
    n_held, worst = 0, 0.0
    over = [0] * len(RATIOS)
    for k in keys:
        r = ratio[k] if held is None else ratio[k][held[k]]
        if r.numel() == 0:
            continue
        n_held += r.numel()
        worst = max(worst, float(r.max()))
        for i, lim in enumerate(RATIOS):
            over[i] += int((r > lim).sum())
    return {"held_share": n_held / total, "worst": worst, "over": dict(zip((f"{v:g}" for v in RATIOS), over))}


if __name__ == "__main__":
    sys.exit(main())

"""Training steps of the reference, and what a training check reads.

A step: the mean teacher-forced loss over the batch (the joint loss: VGG
to fc7, each row over its sum, then the decoder's), its gradient, and
Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected; the learning rate of
each group as the traffic states), after optax's clip by the global norm
where the traffic states a limit.  Dropout multipliers are drawn as the
configuration states: for each step a generator on the device seeded from
the step key (``keys.py``); ``torch.rand`` of the embeddings' (T, B, E), then of
LSTM-2's input (T, B, 2F); keep where the draw is below ``1 - p``,
multiplier ``1 / (1 - p)`` (lrcn.jl:542,547).

The joint step runs its rows in blocks (``block_rows``), which only
bounds memory: the block sums add up to the batch's.
"""

from __future__ import annotations

import torch

from portbench.reference import lrcn, vgg16
from portbench.reference.keys import step_seed

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def dropout(seed: int, shape1, shape2, pdrop: float, device):
    gen = torch.Generator(device=device).manual_seed(step_seed(seed))
    keep = 1.0 - pdrop
    return tuple((torch.rand(s, generator=gen, device=device) < keep
                  ).float() / keep for s in (shape1, shape2))


class Adam:
    def __init__(self, groups: list[tuple[list[str], float]], p: dict):
        self.groups = groups
        self.m = {k: torch.zeros_like(p[k]) for ks, _ in groups for k in ks}
        self.v = {k: torch.zeros_like(p[k]) for ks, _ in groups for k in ks}
        self.t = 0

    def step(self, p: dict, g: dict) -> None:
        self.t += 1
        c1, c2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        for keys, lr in self.groups:
            for k in keys:
                self.m[k] = BETA1 * self.m[k] + (1 - BETA1) * g[k]
                self.v[k] = BETA2 * self.v[k] + (1 - BETA2) * g[k] ** 2
                p[k] = p[k] - lr * (self.m[k] / c1) / (
                    torch.sqrt(self.v[k] / c2) + EPS)


def run_steps(p: dict, batches: list, keys: list[int], cfg: dict,
              traffic: dict, read_at=(), quant=None,
              half_batch: bool = False) -> dict:
    """One step a batch, in order, from parameters ``p`` (a dict of
    float32 tensors under ``decoder/...`` and, for the joint model,
    ``cnn/...`` keys), each batch a dict of device tensors (``tokens``,
    ``lengths``, and ``feats`` or ``images``), step ``s`` with dropout
    key ``keys[s]``.  Returns the losses, the first step's gradient,
    Adam's bias-corrected first moment after each step count in
    ``read_at`` (``moments``) and the parameters after the last step.

    ``half_batch`` plants a fault in the reference: each step's mean
    over the first half of its rows only."""
    pdrop = traffic["dropout"]
    f2 = 2 * cfg["factor_dim"]
    groups = [([k for k in p if k.startswith("decoder/")], traffic["lr"])]
    cnn_keys = [k for k in p if k.startswith("cnn/")]
    if cnn_keys:
        groups.append((cnn_keys, traffic["cnn_lr"]))
    adam = Adam(groups, p)
    p = dict(p)
    losses, first_grad, moments = [], None, {}
    for key_s, batch in zip(keys, batches):
        rows, length = batch["tokens"].shape
        device = batch["tokens"].device
        drop = dropout(key_s, (length + 1, rows, cfg["embed"]),
                       (length + 1, rows, f2), pdrop, device)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        keep = rows // 2 if half_batch else rows
        loss, g = _loss_and_grad(leaves, batch, drop, keep, cfg, traffic,
                                 quant)
        gclip = traffic.get("gclip", 0.0)
        if gclip > 0:       # optax's rule: scale only at or above the limit
            norm = torch.sqrt(sum((v ** 2).sum() for v in g.values()))
            if norm >= gclip:
                g = {k: v * (gclip / norm) for k, v in g.items()}
        if first_grad is None:
            first_grad = {k: v.detach() for k, v in g.items()}
        losses.append(loss)
        adam.step(p, g)
        p = {k: v.detach() for k, v in p.items()}
        if adam.t in read_at:
            moments[adam.t] = {k: m / (1 - BETA1 ** adam.t)
                               for k, m in adam.m.items()}
    return {"losses": losses, "first_grad": first_grad, "moments": moments,
            "params": p}


def _loss_and_grad(leaves, batch, drop, keep, cfg, traffic, quant):
    """The mean loss over the first ``keep`` rows and its gradient, block
    by block: each block's summed NLL over the rows' total count."""
    dec = {k[len("decoder/"):]: v for k, v in leaves.items()
           if k.startswith("decoder/")}
    cnn = {k[len("cnn/"):]: v for k, v in leaves.items()
           if k.startswith("cnn/")}
    count = float((batch["lengths"][:keep].long() + 1).sum())
    block = traffic.get("block_rows", keep)
    loss, grads = 0.0, {k: torch.zeros_like(v) for k, v in leaves.items()}
    for lo in range(0, keep, block):
        hi = min(keep, lo + block)
        if cnn:
            feats = vgg16.l1_normalize(vgg16.fc7(
                cnn, batch["images"][lo:hi], batch["mean"], quant))
        else:
            feats = batch["feats"][lo:hi]
        total, _ = lrcn.loss_sum(dec, batch["tokens"][lo:hi],
                                 batch["lengths"][lo:hi], feats,
                                 (drop[0][:, lo:hi], drop[1][:, lo:hi]),
                                 quant)
        part = total / count
        for k, gk in zip(leaves, torch.autograd.grad(
                part, list(leaves.values()), allow_unused=True)):
            if gk is not None:
                grads[k] += gk
        loss += float(part.detach())
    return loss, grads

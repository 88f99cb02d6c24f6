"""Optimizers as functions on param trees (nested dicts, lists and tuples
of tensors), the reference's ``repro.optim.sgd``: each update returns a
new tree and leaves its inputs as they are. The paper trains with plain
SGD (Eq 2), the default everywhere; momentum and AdamW serve the
framework side. State and arithmetic are fp32; each new param is cast
back to its param's dtype."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

Tree = Any


def _map(fn, *trees: Tree) -> Tree:
    """``fn`` over the leaves of trees of one structure."""
    leaves = [tree_flatten(t) for t in trees]
    spec = leaves[0][1]
    out = [fn(*xs) for xs in zip(*(lv for lv, _ in leaves))]
    return tree_unflatten(out, spec)


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_flatten(tree)[0]))


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, lr) -> Tree:
    return _map(lambda p, g: (p - lr * g.float()).to(p.dtype), params, grads)


@torch.no_grad()
def sgd_update_(params: Tree, grads: Tree, lr) -> Tree:
    """:func:`sgd_update` in place, bit for bit (lr·g rounded, then
    subtracted and cast to the param's dtype); returns ``params``. Besides
    the params and grads it holds one leaf's lr·g at a time, where
    :func:`sgd_update` builds a whole new tree while the old one lives (a
    third copy of the weights: past 80 GB for a full-width 7 B model)."""
    for p, g in zip(tree_flatten(params)[0], tree_flatten(grads)[0]):
        p.sub_(lr * g.float())
    return params


def momentum_init(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def momentum_update(params: Tree, grads: Tree, state: Tree, lr,
                    beta: float = 0.9) -> Tuple[Tree, Tree]:
    new_state = _map(lambda m, g: beta * m + g.float(), state, grads)
    new_params = _map(lambda p, m: (p - lr * m).to(p.dtype), params,
                      new_state)
    return new_params, new_state


def adamw_init(params: Tree) -> Dict:
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else "cpu"
    return {"m": momentum_init(params), "v": momentum_init(params),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Dict, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> Tuple[Tree, Dict]:
    t = state["t"] + 1
    m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
    v = _map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
             state["v"], grads)
    bc1 = 1 - b1 ** t.float()
    bc2 = 1 - b2 ** t.float()

    def upd(p, m_, v_):
        step = lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        return (p - step - lr * weight_decay * p.float()).to(p.dtype)

    return _map(upd, params, m, v), {"m": m, "v": v, "t": t}


def make_optimizer(name: str) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params) -> state, update_fn(params, grads, state, lr)
    -> (params, state))."""
    if name == "sgd":
        return (lambda p: (), lambda p, g, s, lr: (sgd_update(p, g, lr), s))
    if name == "momentum":
        return (momentum_init,
                lambda p, g, s, lr: momentum_update(p, g, s, lr))
    if name == "adamw":
        return (adamw_init, lambda p, g, s, lr: adamw_update(p, g, s, lr))
    raise ValueError(f"unknown optimizer {name!r}")

"""One client's train step, prefill and decode over a ``("data", "model")``
placement (:mod:`repro_torch.sharding.place`): the dense, MoE and
stub-prefix families' compute on each rank's blocks, the port's
counterpart of the reference's steps jitted with ``in_shardings`` on a
mesh under its ``set_mesh`` (``launch/dryrun.py``).

  - **Batch over "data".** Each data rank runs its rows. The loss is the
    rank's summed token cross-entropy over the GLOBAL count of unmasked
    labels (one all-reduce of the count), so the D ranks' losses sum to the
    reference's one loss, and the gradients summed over "data" are its
    gradients.
  - **Heads and d_ff over "model", Megatron style.** ``wq``, ``wk``,
    ``wv`` (and their biases), ``w_gate`` and ``w_up`` are column-parallel,
    ``wo`` and ``w_down`` row-parallel; the two autograd operators
    :class:`CopyToModel` (identity forward, all-reduce over "model"
    backward) and :class:`ReduceFromModel` (all-reduce forward, identity
    backward) bracket each split half-block. A rank runs K3 at its H/T query
    heads and the KV heads they read: KH/T of them, or, when a KV head is
    shared by several ranks' query heads (KH < T), that one head. Attention
    is split when T divides H and a rank's heads fall within KV groups or
    cover whole ones; the MLP when T divides d_ff. A half-block that is not
    split runs whole on every model rank, on weights gathered whole.
  - **Experts over "model"** (:class:`MoEPlan`). The expert axis is padded
    to E' = E + (-E mod T), as the reference pads it; model rank t runs
    experts [t·E'/T, (t+1)·E'/T) ∩ [0, E) (a padded expert never gets a
    slot). Its compute form is those experts' slices of the ``(E, D, F)``
    stacks, gathered over "data"; where T does not divide E the stack is
    stored whole on E and the rank slices its range out, and its frame's
    gradient is then summed over "model" too. There is no all-to-all: a
    data rank's tokens are already on every model rank, so each model
    rank works out the whole routing plan of its rows (the router
    gathered whole), packs only its experts' slots and combines only their
    pairs (``models/moe.py::expert_mix``). The normed input and the gates
    enter the split through :class:`CopyToModel` and the partial outputs
    leave through :class:`ReduceFromModel`, so the router's gradient is
    the same on every model rank and is not summed over "model". The
    reference's all-to-all before its grouped product (``moe.py``'s
    expert-parallel reshard) has no counterpart. Routing is group-local
    as the reference's under a mesh: a data rank's rows are one group of
    the reference's G = |data|, with the capacity of its B/D·S tokens (B/D
    in decode); where the batch is not split but D divides the rank's
    tokens, it routes them in D groups. A shared expert is placed as the
    dense MLP (split when T divides its width), the ``first_k_dense``
    layers are dense blocks. Each data rank's aux loss is its share,
    E·Σ_e frac_e·(Σ_{t in rank} p_te)/T, with the expert counts and T
    summed over "data" without a gradient: the shares sum to the
    reference's aux and give its gradient, and each layer's is added to
    the loss as ``model.loss_fn`` adds it.
  - **Leaves whose split the compute does not follow** are gathered along
    those axes before use and freed after it: the "data" (FSDP) half of
    every matrix, ``embed`` and ``lm_head`` in training (no vocab-parallel
    cross-entropy yet), and a "model" split off whole heads (full-width
    smollm-135m at T = 2 splits ``wq`` at head 4.5), each leaf's compute
    form then sliced out of the gathered leaf. The math is the reference's;
    only the order of sums changes. Prefill and decode gather only the
    "data" half of ``embed`` and ``lm_head``: a rank looks the tokens up in
    its vocab rows and computes its vocab columns of the logits (one
    all-reduce and one all-gather over "model").
  - **Gradients.** A compute form's gradient is laid into its frame (the
    leaf gathered along the axes it was gathered along), the frames summed
    over the ranks that hold the same frame (over "data" when the batch is
    split; over "model" too when the model ranks' contributions to one
    frame differ: a leaf gathered over "model", or sliced from a replicated
    one, in a split half-block), and each rank keeps its block and updates
    it in place (``_sgd_in_param_dtype_``). gloo has no ``reduce_scatter``,
    so that sum is an all-reduce of the frame followed by taking the
    rank's block; the frames are packed into one buffer a reduction group
    and dtype, so a step makes at most three all-reduces of gradients.
  - **Prefill** returns the last-token logits whole on every rank (one
    all-gather over "data") and this rank's blocks of the cache in
    ``cache_shardings``' layout; **decode** writes the new token into those
    blocks (through a gathered copy of the layer's cache where the cache's
    split is not the compute's: the head-dim fallback, shared KV heads) and
    returns whole logits.

A stack whose layer axis the rules split (an MoE shared expert's
``(L, D, F)`` leaf takes the expert rule, "model" on L, when T divides
L) is gathered whole along it for the step and the rank's layers written
back after the update.

The stub-prefix families (``vlm``, ``audio``: qwen2-vl-2b, musicgen-large)
are dense blocks after a prefix of ``n_stub_tokens`` frontend embeddings:
a batch's ``stub_embeds`` (B, n_stub, D) is split over "data" with the
tokens (the reference's ``batch_spec``) and put before the rank's token
embeddings; explicit ``positions`` (S_eff,) or M-RoPE's (S_eff, 3) are
replicated; the logits come from the token positions only. A decode
step's position is (1, 3) under M-RoPE, as ``models/model.py::decode``
builds it.

There is no fallback: a sharded step never runs unsharded, a collective
that fails raises, and K3 on a CUDA tensor launches or raises. The MLA,
SSM and hybrid families raise NotImplementedError naming their ROADMAP
item (D1c).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.train import (_STACKED, _layered,
                                      _sgd_in_param_dtype_, value_and_grad)
from repro_torch.models import attention as attn
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (embed_apply, mlp_apply, rmsnorm,
                                       unembed_apply)
from repro_torch.sharding import place
from repro_torch.sharding.place import Placement
from repro_torch.sharding.rules import (Spec, _map_with_path, cache_shardings,
                                        param_shardings)

Params = Any


def check_placeable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless ``cfg`` is of the dense, the MoE or
    a stub-prefix family (``vlm``, ``audio``) with GQA attention, naming
    the ROADMAP item of the rest (D1c: MLA, SSM, hybrid)."""
    if cfg.family in ("dense", "moe", "vlm", "audio") and not (
            cfg.mla or cfg.ssm or cfg.mtp_depth):
        return
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r}{' with MLA' if cfg.mla else ''} "
        f"is not placed within a client yet; the sharded steps run the "
        f"dense, MoE and stub-prefix families with GQA attention (ROADMAP "
        f"D1c: the MLA, SSM and hybrid families)")


def plan_for(cfg: ModelConfig, pl: Placement, shape: ShapeConfig
             ) -> "DensePlan":
    """The plan of ``cfg``'s family: :class:`MoEPlan` or
    :class:`DensePlan`."""
    return (MoEPlan if cfg.moe else DensePlan)(cfg, pl, shape)


class CopyToModel(torch.autograd.Function):
    """Enter a split half-block: identity forward; backward, the model
    ranks' partial input gradients summed (all-reduce over "model")."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return place.all_reduce(grad.contiguous().clone(), ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """Leave a split half-block: the model ranks' partial outputs summed
    (all-reduce over "model"); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return place.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class LeafUse(NamedTuple):
    """How one leaf (one layer's, for a stacked one) enters the compute:
    its storage ``spec``; the axes it is ``gather``-ed along; ``take``, the
    compute form's slices of the gathered leaf (its frame); ``keep``, the
    rank's block within the frame; ``sum_axes``, the axes over which the
    frames' gradients are summed."""
    spec: Spec
    gather: Tuple[str, ...]
    frame: Tuple[int, ...]
    take: Tuple[slice, ...]
    keep: Tuple[slice, ...]
    sum_axes: Tuple[str, ...]


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def leaf_use(spec: Spec, shape: Sequence[int],
             ranges: Optional[Sequence[Optional[Tuple[int, int]]]],
             partitioned: bool, batch_split: bool,
             pl: Placement) -> LeafUse:
    """The :class:`LeafUse` of a leaf of global ``shape`` stored under
    ``spec`` whose compute form is ``ranges`` (a [start, stop) a dim, None
    for the whole dim; None: the whole leaf). ``partitioned``: the model
    ranks compute different parts with it (a split half-block)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    want = [(r if ranges and r else (0, d)) for r, d in
            zip(ranges or [None] * len(shape), shape)]
    blocks = [place.block_range(e, d, pl) for e, d in zip(spec, shape)]
    gather: List[str] = []
    for e, blk, w in zip(spec, blocks, want):
        axes = [a for a in _entry_axes(e) if pl.sizes.get(a, 1) > 1]
        # the compute never follows "data": a dim split over it is
        # gathered on every rank, even the one whose block is what it
        # wants, so that all ranks make the same collectives
        if blk != w or "data" in axes:
            gather += [a for a in axes if a not in gather]
    frame, take, keep = [], [], []
    model_varies = False
    for e, d, blk, w in zip(spec, shape, blocks, want):
        axes = [a for a in _entry_axes(e) if pl.sizes.get(a, 1) > 1]
        lo, hi = (0, d) if all(a in gather for a in axes) else blk
        if "model" in axes and "model" not in gather:
            model_varies = True
        frame.append(hi - lo)
        take.append(slice(w[0] - lo, w[1] - lo))
        keep.append(slice(blk[0] - lo, blk[1] - lo))
    sums = []
    if batch_split:
        sums.append("data")
    if partitioned and pl.sizes["model"] > 1 and not model_varies:
        sums.append("model")
    return LeafUse(spec, tuple(gather), tuple(frame), tuple(take),
                   tuple(keep), tuple(sums))


def _whole(slices: Tuple[slice, ...], frame: Tuple[int, ...]) -> bool:
    """Whether ``slices`` take all of a tensor of shape ``frame``."""
    return all(s.start == 0 and s.stop == n for s, n in zip(slices, frame))


def _mlp_ranges(name: str, f: Tuple[int, int]):
    """An MLP leaf's compute form at d_ff columns ``f``: ``w_gate`` and
    ``w_up`` column-parallel, ``w_down`` row-parallel."""
    return (f, None) if name == "w_down" else (None, f)


def _at(tree, names: Tuple[str, ...]):
    for n in names:
        tree = tree[n]
    return tree


class DensePlan:
    """Where each rank's heads, columns and rows lie, and how each leaf of
    the dense model enters its compute, for ``cfg`` on placement ``pl`` at
    ``shape`` (its global_batch says whether the batch is split over
    "data": D divides it)."""

    def __init__(self, cfg: ModelConfig, pl: Placement, shape: ShapeConfig):
        check_placeable(cfg)
        self.cfg, self.pl, self.shape = cfg, pl, shape
        D, T = pl.sizes["data"], pl.sizes["model"]
        t = pl.coords["model"]
        H, KH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        G = H // KH
        h = H // T if H % T == 0 else 0
        self.attn_split = T > 1 and h > 0 and (h % G == 0 or G % h == 0)
        if self.attn_split:
            self.heads, kh = h, max(1, h // G)
        else:
            self.heads, kh = H, KH
        self.G = G
        self.q0 = t * h if self.attn_split else 0
        self.kv0 = self.q0 // G
        self.kv_heads = kh
        self.attn_cfg = dataclasses.replace(cfg, n_heads=self.heads,
                                            n_kv_heads=kh, head_dim=dh)
        self.mlp_split = T > 1 and cfg.d_ff % T == 0
        f = cfg.d_ff // T if self.mlp_split else cfg.d_ff
        self.f_range = (t * f, (t + 1) * f) if self.mlp_split else None
        self.batch_split = D > 1 and shape.global_batch % D == 0
        self.rows = (shape.global_batch // D if self.batch_split
                     else shape.global_batch)
        self.data_group = pl.group("data") if self.batch_split else None
        self.model_group = pl.group("model")
        self._init_family()
        meta = model_lib.init_params(cfg, torch.Generator(), device="meta")
        self.specs = param_shardings(pl.mesh, meta)
        self.stacks = [g for g in _STACKED if g in meta]
        self.top = {k: self._use((k,), tuple(v.shape), self.specs[k])
                    for k, v in meta.items() if k not in self.stacks}
        # each stacked group's per-layer uses; the stacks whose layer axis
        # the rules split (gathered along it for a step: _unsplit_stacks)
        self.group_uses, self.stack_split = {}, {}
        for g in self.stacks:
            stacked = place.spec_items(self.specs[g])
            self.group_uses[g] = _map_with_path(
                lambda names, x: self._use(names, tuple(x.shape[1:]),
                                           stacked[names][1:]), meta[g])
            for names, spec in stacked.items():
                if spec and spec[0] is not None:
                    self.stack_split[(g,) + names] = spec[0]
        self.layer_uses = self.group_uses["layers"]
        kv = model_lib.init_cache(cfg, shape.global_batch, 1,
                                  device="meta")
        self.kv_spec = cache_shardings(pl.mesh, kv)["layers"]["k"][1:]

    def _init_family(self) -> None:
        """What a family's plan adds before the leaves' uses are made."""

    # ------------------------------------------------------------ layout
    def _ranges(self, names: Tuple[str, ...], shape: Tuple[int, ...]):
        """(the compute form's ranges, partitioned) of a leaf by its path
        within the tree (or its layer) and its (per-layer) shape."""
        name = names[-1]
        parent = names[-2] if len(names) > 1 else None
        dh = self.cfg.resolved_head_dim
        if self.attn_split and parent == "attn":
            q = (self.q0 * dh, (self.q0 + self.heads) * dh)
            kv = (self.kv0 * dh, (self.kv0 + self.kv_heads) * dh)
            table = {"wq": (None, q), "bq": (q,), "wk": (None, kv),
                     "wv": (None, kv), "bk": (kv,), "bv": (kv,),
                     "wo": (q, None)}
            if name in table:
                return table[name], True
        if self.mlp_split and parent == "mlp" and \
                name in ("w_gate", "w_up", "w_down"):
            return _mlp_ranges(name, self.f_range), True
        return None, False

    def _use(self, names: Tuple[str, ...], shape: Tuple[int, ...],
             spec: Spec) -> LeafUse:
        ranges, part = self._ranges(names, shape)
        return leaf_use(spec, shape, ranges, part, self.batch_split, self.pl)

    def _form(self, block: torch.Tensor, use: LeafUse) -> torch.Tensor:
        """A leaf's compute form from this rank's block."""
        full = place.gather_leaf(block, use.spec, self.pl, use.gather)
        return full if _whole(use.take, use.frame) else full[use.take]

    def top_form(self, blocks: Params, name: str) -> torch.Tensor:
        return self._form(blocks[name], self.top[name])

    def layer_form(self, layer_blocks: Params,
                   group: str = "layers") -> Params:
        """One layer's compute forms from its blocks (views of the stack)."""
        return _zip_map(self._form, layer_blocks, self.group_uses[group])

    def compute_tree(self, blocks: Params) -> Params:
        """Every leaf's compute form: the top-level leaves, and each
        stacked group as a list of per-layer trees (``_layered``'s
        structure)."""
        layered = _layered(blocks)
        return {k: ([self.layer_form(lb, k) for lb in layered[k]]
                    if k in self.stacks else self.top_form(blocks, k))
                for k in blocks}

    def unsplit_stacks(self, blocks: Params) -> Params:
        """``blocks`` with each stack whose layer axis the rules split
        gathered whole along it (one all-gather a leaf); ``blocks``
        itself when there is none."""
        if not self.stack_split:
            return blocks
        return _map_with_path(
            lambda names, x: place.gather_leaf(
                x, (self.stack_split[names],), self.pl)
            if names in self.stack_split else x, blocks)

    @torch.no_grad()
    def restore_stacks(self, blocks: Params, work: Params) -> None:
        """Write this rank's layers of each gathered stack of ``work``
        (:meth:`unsplit_stacks`) back into its blocks."""
        for names, entry in self.stack_split.items():
            full = _at(work, names)
            lo, hi = place.block_range(entry, full.shape[0], self.pl)
            _at(blocks, names).copy_(full[lo:hi])

    def check_rows(self, x: torch.Tensor, what: str) -> None:
        if x is None:
            return
        if x.shape[0] != self.rows:
            raise ValueError(
                f"{what} holds {x.shape[0]} rows; this rank's block of a "
                f"global batch of {self.shape.global_batch} over "
                f"{self.pl.sizes['data']} data ranks is {self.rows} "
                "(place.batch_blocks)")

    # ----------------------------------------------------------- compute
    def _enter(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        return CopyToModel.apply(x, self.model_group) if split else x

    def _leave(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        return ReduceFromModel.apply(y, self.model_group) if split else y

    def _ffn(self, p: Params, x: torch.Tensor, aux: bool = False):
        """The block's second half on the residual ``x``: (x + its MLP,
        None); :class:`MoEPlan` adds the MoE and its aux share."""
        hn = rmsnorm(p["ln2"], x, self.cfg.norm_eps)
        return x + self._leave(mlp_apply(p["mlp"], self._enter(
            hn, self.mlp_split)), self.mlp_split), None

    def _train_block(self, p: Params, x: torch.Tensor, pos: torch.Tensor,
                     window: int, consecutive: bool):
        hn = rmsnorm(p["ln1"], x, self.cfg.norm_eps)
        y = attn.gqa_apply(p["attn"], self.attn_cfg,
                           self._enter(hn, self.attn_split), positions=pos,
                           window=window, consecutive=consecutive)
        return self._ffn(p, x + self._leave(y, self.attn_split), aux=True)

    def _xent(self, logits: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        """``model.softmax_xent`` with the mean over the global count."""
        mask = (labels >= 0).float()
        safe = torch.clamp(labels, min=0).long()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
        count = torch.sum(mask)
        if self.data_group is not None:
            count = place.all_reduce(count.detach().clone(), self.data_group)
        return torch.sum((lse - ll) * mask) / torch.clamp(count, min=1.0)

    def loss_fn(self, params: Params, cfg: ModelConfig, batch: Dict, *,
                window: int = 0, remat: bool = False):
        """This rank's share of ``model.loss_fn`` on compute forms (its
        rows' token losses over the global count, plus its share of the
        MoE layers' aux losses; equal on the model ranks). ``mtp`` is 0;
        ``aux`` is 0 without an MoE layer."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        window = window or cfg.sliding_window
        x, pos, consecutive = model_lib._inputs(
            params, cfg, tokens, batch.get("stub_embeds"),
            batch.get("positions"))
        aux = None
        for g in self.stacks:
            for p in params[g]:
                x, a = model_lib._remat(self._train_block, remat, p, x, pos,
                                        window, consecutive)
                if a is not None:
                    aux = a if aux is None else aux + a
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = model_lib.logits_from_hidden(params, cfg, h[:, -S:])
        xent = self._xent(logits, batch["labels"])
        zero = torch.zeros((), dtype=torch.float32, device=xent.device)
        if aux is None:
            return xent, {"xent": xent, "aux": zero, "mtp": zero}
        return xent + aux, {"xent": xent, "aux": aux, "mtp": zero}

    def reduce_grads(self, grads: Params) -> Params:
        """The blocks' gradients from the compute forms': frames summed over
        each leaf's ``sum_axes`` (one all-reduce a group and dtype), then
        the rank's block kept."""
        uses = {k: ([self.group_uses[k]] * len(g) if k in self.stacks
                    else self.top[k]) for k, g in grads.items()}
        pairs: List[Tuple[LeafUse, torch.Tensor]] = []
        _zip_map(lambda g, u: pairs.append((u, g)), grads, uses)
        out = iter(self.reduce_pairs(pairs))
        return _zip_map(lambda g, u: next(out), grads, uses)

    def reduce_pairs(self, pairs: Sequence[Tuple[LeafUse, torch.Tensor]]
                     ) -> List[torch.Tensor]:
        """:meth:`reduce_grads` on a list of (use, compute-form gradient):
        each one's block gradient, in order."""
        frames = []
        for use, g in pairs:
            if _whole(use.take, use.frame):
                frames.append(g)
            else:
                f = g.new_zeros(use.frame)
                f[use.take] = g
                frames.append(f)
        buckets: Dict[Tuple, List[int]] = {}
        for i, (use, g) in enumerate(pairs):
            if use.sum_axes:
                buckets.setdefault((use.sum_axes, str(g.dtype)), []).append(i)
        groups = {("data",): self.pl.group("data"),
                  ("model",): self.pl.group("model"),
                  ("data", "model"): None}          # the whole world
        for key in sorted(buckets):
            idx = buckets[key]
            flat = torch.cat([frames[i].reshape(-1) for i in idx])
            place.all_reduce(flat, groups[key[0]])
            for i, part in zip(idx, flat.split([frames[i].numel()
                                                for i in idx])):
                frames[i] = part.view(frames[i].shape)
        return [f if _whole(u.keep, u.frame) else f[u.keep].contiguous()
                for (u, _), f in zip(pairs, frames)]

    # ------------------------------------------------------------ caches
    def _kv_gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, KH, Dh) from every model rank's (B, S, kv_heads, Dh) of
        its KV heads kv0.. (one all-gather over "model")."""
        parts = place.all_gather(x.contiguous()[None], self.model_group, 0)
        full = x.new_empty(x.shape[:2] + (self.cfg.n_kv_heads,)
                           + x.shape[3:])
        for t, part in enumerate(parts):
            j = t * self.heads // self.G
            full[:, :, j:j + self.kv_heads] = part
        return full

    def _kv_identity(self) -> bool:
        """Whether this rank's cache block of a layer is its compute form
        (heads over "model" exactly as the compute splits them)."""
        if self.pl.sizes["model"] == 1:
            return True
        if not self.attn_split or self.kv_spec[2] != "model":
            return False
        return place.block_range("model", self.cfg.n_kv_heads, self.pl) == \
            (self.kv0, self.kv0 + self.kv_heads)

    def kv_to_storage(self, kv: Dict[str, torch.Tensor]) -> Dict:
        """A layer's computed k/v (B_rows, S, kv_heads, Dh) as this rank's
        cache block in ``cache_shardings``' layout."""
        if self._kv_identity():
            return kv
        out = {}
        for name, x in kv.items():
            full = self._kv_gather_heads(x) if self.attn_split else x
            spec = (None, None) + tuple(self.kv_spec[2:])
            out[name] = full[place.block_slices(spec, full.shape,
                                                self.pl)].contiguous()
        return out

    def kv_to_compute(self, blocks: Dict[str, torch.Tensor]) -> Dict:
        """A layer's cache blocks as the compute's (B_rows, S, kv_heads,
        Dh): the blocks themselves, or a gathered copy."""
        if self._kv_identity():
            return blocks
        spec = (None, None) + tuple(self.kv_spec[2:])
        out = {}
        for name, x in blocks.items():
            full = place.gather_leaf(x, spec, self.pl, ("model",))
            out[name] = (full[:, :, self.kv0:self.kv0 + self.kv_heads]
                         .contiguous() if self.attn_split else full)
        return out

    def rows_whole(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows, in order (one all-gather over "data")."""
        if self.data_group is None:
            return x
        return place.all_gather(x.contiguous(), self.data_group, 0)

    def _vocab_split(self, name: str, dim: int) -> bool:
        """Whether leaf ``name``'s vocab dim ``dim`` is split over
        "model"."""
        return (self.pl.sizes["model"] > 1
                and self.top[name].spec[dim] == "model")

    def _embed_tokens(self, blocks: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' embeddings without the whole table: each model rank
        looks up the tokens in its vocab rows (gathered over "data") and
        zeroes the others; one all-reduce over "model" sums the one row a
        token has (exact: the other ranks add zeros)."""
        if not self._vocab_split("embed", 0):
            return embed_apply(self.top_form(blocks, "embed"), tokens)
        rows = place.gather_leaf(blocks["embed"], self.top["embed"].spec,
                                 self.pl, ("data",))
        lo, hi = place.block_range("model", self.cfg.vocab, self.pl)
        local = tokens.long() - lo
        inside = (local >= 0) & (local < hi - lo)
        x = rows[torch.clamp(local, 0, hi - lo - 1)] * \
            inside[..., None].to(rows.dtype)
        return place.all_reduce(x, self.model_group)

    def _logits(self, blocks: Params, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits without the whole head: each model rank's vocab
        columns (gathered over "data"), then one all-gather over "model"
        along the vocab; tied or unsplit heads are gathered whole."""
        if self.cfg.tie_embeddings or not self._vocab_split("lm_head", 1):
            name = "embed" if self.cfg.tie_embeddings else "lm_head"
            return model_lib.logits_from_hidden(
                {name: self.top_form(blocks, name)}, self.cfg, h)
        cols = place.gather_leaf(blocks["lm_head"], self.top["lm_head"].spec,
                                 self.pl, ("data",))
        part = unembed_apply(cols, h, transpose=False)
        return place.all_gather(part.contiguous(), self.model_group,
                                part.dim() - 1)

    def _serve_inputs(self, blocks: Params, batch: Dict):
        """(the rank's stub rows, when given, then its embedded tokens;
        positions; whether they are 0..S_eff-1)."""
        x = self._embed_tokens(blocks, batch["tokens"])
        stub = batch.get("stub_embeds")
        if self.cfg.n_stub_tokens and stub is not None:
            self.check_rows(stub, "stub_embeds")
            x = torch.cat([stub.to(x.dtype), x], dim=1)
        positions = batch.get("positions")
        if positions is None:
            return (x, model_lib._positions_default(self.cfg, x.shape[1],
                                                    x.device), True)
        return x, positions, False

    @torch.no_grad()
    def prefill(self, blocks: Params, batch: Dict, window: int = 0):
        """(last-token logits (B, V) whole, this rank's cache blocks)."""
        cfg = self.cfg
        self.check_rows(batch["tokens"], "tokens")
        window = window or cfg.sliding_window
        blocks = self.unsplit_stacks(blocks)
        x, pos, consecutive = self._serve_inputs(blocks, batch)
        layered, cache = _layered(blocks), {}
        for g in self.stacks:
            caches = []
            for lb in layered[g]:
                p = self.layer_form(lb, g)
                y, kv = attn.gqa_prefill(
                    p["attn"], self.attn_cfg,
                    rmsnorm(p["ln1"], x, cfg.norm_eps), positions=pos,
                    window=window, consecutive=consecutive)
                x, _ = self._ffn(p, x + self._leave(y, self.attn_split))
                caches.append(self.kv_to_storage(kv))
                del p, kv
            cache[g] = model_lib._stack_caches(caches)
        h = rmsnorm(self.top_form(blocks, "ln_f"), x[:, -1:], cfg.norm_eps)
        logits = self._logits(blocks, h)
        return self.rows_whole(logits[:, 0]), cache

    @torch.no_grad()
    def decode(self, blocks: Params, cache: Dict, batch: Dict,
               window: int = 0):
        """(logits (B, V) whole, ``cache``): the new token written into this
        rank's cache blocks in place."""
        cfg = self.cfg
        self.check_rows(batch["token"], "token")
        window = window or cfg.sliding_window
        pos = int(batch["pos"])
        blocks = self.unsplit_stacks(blocks)
        x = self._embed_tokens(blocks, batch["token"])
        shape = (1, 3) if cfg.rope == "mrope" else (1,)
        positions = torch.full(shape, pos, dtype=torch.int32, device=x.device)
        slot = (pos % window) if window else pos
        layered = _layered(blocks)
        for g in self.stacks:
            for i, lb in enumerate(layered[g]):
                p = self.layer_form(lb, g)
                mine = {name: c[i] for name, c in cache[g].items()}
                work = self.kv_to_compute(mine)
                y, _ = attn.gqa_decode(p["attn"], self.attn_cfg,
                                       rmsnorm(p["ln1"], x, cfg.norm_eps),
                                       cache=work, pos=pos,
                                       positions=positions, window=window)
                if work is not mine:          # write the new slot back
                    new = self.kv_to_storage(
                        {n: w[:, slot:slot + 1] for n, w in work.items()})
                    for n, c in mine.items():
                        c[:, slot] = new[n][:, 0]
                x, _ = self._ffn(p, x + self._leave(y, self.attn_split))
                del p, work
        h = rmsnorm(self.top_form(blocks, "ln_f"), x, cfg.norm_eps)
        logits = self._logits(blocks, h)
        return self.rows_whole(logits[:, 0]), cache


class MoEPlan(DensePlan):
    """:class:`DensePlan` for the MoE family: the attention and the
    ``dense_layers``' MLPs as the dense plan places them; each MoE layer's
    experts over "model" (this rank's ``e_range`` of the padded expert
    axis), routed group-local over "data", the shared expert as the dense
    MLP. ``routing``: a list to which each MoE call appends
    ``models/moe.py::routing_stats`` of this rank's routing (None: not
    recorded)."""

    def _init_family(self) -> None:
        m = self.cfg.moe
        T, t = self.pl.sizes["model"], self.pl.coords["model"]
        per = (m.n_experts + (-m.n_experts) % T) // T
        self.e_range = (min(t * per, m.n_experts),
                        min((t + 1) * per, m.n_experts))
        width = m.expert_d_ff * m.n_shared_experts
        self.shared_split = T > 1 and width > 0 and width % T == 0
        self.shared_range = ((t * width // T, (t + 1) * width // T)
                             if self.shared_split else None)
        self.routing: Optional[list] = None

    def _ranges(self, names: Tuple[str, ...], shape: Tuple[int, ...]):
        if "moe" not in names:
            return super()._ranges(names, shape)
        name = names[-1]
        if names[-2] == "shared":
            if self.shared_split:
                return _mlp_ranges(name, self.shared_range), True
            return None, False
        if len(shape) == 3 and name in ("w_gate", "w_up", "w_down"):
            return (self.e_range, None, None), True
        return None, False                  # the router: whole

    def route_groups(self, n_tokens: int) -> int:
        """The groups this rank routes its ``n_tokens`` in: its rows are
        one of the reference's |data| groups when the batch is split;
        otherwise it holds every row and routes them in D groups where D
        divides them (the reference's rule)."""
        D = self.pl.sizes["data"]
        if self.batch_split or D == 1:
            return 1
        return moe_mod.n_groups(n_tokens, D)

    def _ffn(self, p: Params, x: torch.Tensor, aux: bool = False):
        if "mlp" in p:
            return super()._ffn(p, x, aux)
        y, a = self._moe(p["moe"], rmsnorm(p["ln2"], x, self.cfg.norm_eps),
                         aux)
        return x + y, a

    def _moe(self, p: Params, hn: torch.Tensor, aux: bool):
        """(the MoE layer's output on this rank's rows, its aux share or
        None): every model rank routes the rows whole, runs its experts'
        slots, and the partial outputs are summed over "model"."""
        m = self.cfg.moe
        B, S, D = hn.shape
        T = B * S
        xt = hn.reshape(T, D)
        gates, ids, probs = moe_mod.router_probs(p["router"], xt, m.top_k)
        G = self.route_groups(T)
        plan = moe_mod.route_plan(ids, m.n_experts,
                                  moe_mod.capacity(m, T // G), G)
        if self.routing is not None:
            self.routing.append(moe_mod.routing_stats(p["router"], xt, m,
                                                      G))
        split = self.pl.sizes["model"] > 1
        xs = self._enter(xt, split)
        part = moe_mod.expert_mix(p, plan, xs, self._enter(gates, split),
                                  self.e_range[0])
        if "shared" in p and self.shared_split:
            part = part + mlp_apply(p["shared"], xs)
        out = self._leave(part, split)
        if "shared" in p and not self.shared_split:
            out = out + mlp_apply(p["shared"], xt)
        return out.view(B, S, D), (self._aux_share(probs, ids) if aux
                                   else None)

    def _aux_share(self, probs: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
        """This data rank's share of ``load_balance_loss`` ·
        ``router_aux_weight``: E · Σ_e frac_e · (Σ_{t in rank} p_te) / T,
        frac and T over every data rank's tokens (one all-reduce over
        "data", no gradient)."""
        m = self.cfg.moe
        E = m.n_experts
        stats = torch.cat([moe_mod.expert_counts(ids, E).float(),
                           torch.full((1,), float(ids.shape[0]),
                                      device=ids.device)])
        if self.data_group is not None:
            place.all_reduce(stats, self.data_group)
        counts, n_tokens = stats[:E], stats[E]
        frac = counts / torch.clamp(n_tokens * m.top_k, min=1.0)
        return E * torch.sum(frac * probs.sum(dim=0) / n_tokens) * \
            m.router_aux_weight


def _zip_map(fn, tree, other):
    """``fn(leaf, other's leaf)`` over two trees of one structure (dicts and
    lists)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def make_train_step(cfg: ModelConfig, train: TrainConfig, shape: ShapeConfig,
                    placement: Placement, window: int):
    """``launch/steps.py::make_train_step`` over ``placement``:
    ``train_step(param_blocks, batch_blocks) -> (param_blocks, metrics)``;
    the blocks updated in place; the metrics summed over "data", so every
    rank reports the reference's loss."""
    plan = plan_for(cfg, placement, shape)

    def train_step(params: Params, batch: Dict):
        plan.check_rows(batch["tokens"], "tokens")
        plan.check_rows(batch.get("stub_embeds"), "stub_embeds")
        work = plan.unsplit_stacks(params)
        compute = plan.compute_tree(work)
        loss, metrics, grads = value_and_grad(
            compute, cfg, batch, window=window, remat=train.remat,
            by_layer=True, objective=plan.loss_fn)
        del compute
        _sgd_in_param_dtype_(_layered(work), plan.reduce_grads(grads),
                             train.lr)
        plan.restore_stacks(params, work)
        del work
        names = ("xent", "aux", "mtp")
        packed = torch.stack([loss.float()] + [metrics[k].detach().float()
                                               for k in names])
        if plan.data_group is not None:
            place.all_reduce(packed, plan.data_group)
        loss, *rest = packed.unbind()
        return params, dict(zip(names, rest), loss=loss)

    train_step.plan = plan
    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      placement: Placement, window: int):
    """``prefill_step(param_blocks, batch_blocks) -> (logits whole, cache
    blocks)``."""
    plan = plan_for(cfg, placement, shape)

    def prefill_step(params: Params, batch: Dict):
        return plan.prefill(params, batch, window)

    prefill_step.plan = plan
    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                     placement: Placement, window: int):
    """``decode_step(param_blocks, cache_blocks, batch_blocks) -> (logits
    whole, cache_blocks)``."""
    plan = plan_for(cfg, placement, shape)

    def decode_step(params: Params, cache: Dict, batch: Dict):
        return plan.decode(params, cache, batch, window)

    decode_step.plan = plan
    return decode_step

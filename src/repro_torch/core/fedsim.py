"""N-client federated simulator, fused and legacy engines, for every method
of the reference: ``local``, ``fedavg``, ``fedprox``, ``perfedavg``,
``fedamp`` and ``pfedwn``.

Clients hold one stacked flat param buffer (N, P) (leaf views per
:func:`repro_torch.models.cnn.param_layout`). Every train and test tensor is
staged on the device once, in :class:`FederatedSimulation`'s constructor;
minibatch indices and link erasures are drawn on the device, so a round runs
as a Python loop of device work and the host syncs only at the eval points
of :func:`block_schedule`. One pFedWN round (each phase is a
``torch.profiler`` range, ``fedsim.<phase>``):

  1. ``local_sgd``: every client, participant or not, runs local SGD on
     its CNN;
  2. ``em``: the target (client 0) runs EM (Eq 9-11) on *copies* of its M
     neighbours' models, with the E-step in the fused CE + posterior kernel
     (uniform π instead under ``em_uniform``);
  3. ``mix``: the erasure-gated Eq-1 mix of the target with the
     *unrefined* locally trained neighbours, in one kernel launch over the
     stacked buffer;
  4. ``target_sgd``: the target trains from the aggregate, on the same
     minibatch indices as step 1.

The four baselines (:mod:`repro_torch.core.baselines`) run their local
training in the ``local_sgd`` range and their aggregation in ``aggregate``;
they launch no kernel. Per-FedAvg's target is adapted by one MAML step
before it is scored.

The generator's bits differ from ``jax.random``'s, so :meth:`
FederatedSimulation.run` also accepts injected index streams and link masks
(a parity test replays the reference's draws through them).

``FedSimConfig(sharded=True, shard_devices=D)`` selects the client-sharded
engine, the reference's ``shard_map`` engine on ``torch.distributed``: one
process a rank (:func:`repro_torch.sharding.spawn` starts them), each rank
r holding the contiguous slab of S = N / D clients from r·S on in a
``"clients"`` group of D ranks (:func:`repro_torch.sharding.client_group`).
Every exchange across clients is an explicit collective
(:mod:`repro_torch.core.aggregation`): one ``client_weighted_mean``
all-reduce for the FedAvg-family mean (two for FedProx, whose anchor is the
mean before training), one ``gather_clients`` all-gather a round of the
peer models for FedAMP's attention and pFedWN's EM components, and one
small ``exchange_block`` a block for the eval and the taps. The target's
math (EM through K1, the Eq-1 mix through K2, its pass after aggregation)
runs on every rank, and only the rank holding client 0 writes it back.
Every rank draws the full (N, steps, B) indices and the link mask from the
same generator and uses its slab, so with the same seed or the same
injected draws the sharded engine follows the fused trajectory. Only rank
0 writes the RunRecord's files.

``FedSimConfig(fused=False)`` selects the legacy host-driven engine, the
reference's parity and debugging path: each round it brings the indices
drawn on the device (from the same generator, in the same order) to the
host, gathers every client's minibatches there with numpy and uploads them,
runs the same round math (:meth:`FederatedSimulation._round`, so pFedWN
still launches K1 and K2), and at each eval point scores the target and
then each participant in turn on its unpadded test set. With the same seed
or the same injected draws both engines follow the same trajectory.

Telemetry (:mod:`repro_torch.obs`): every simulation owns a
``RunRecorder``, and each ``run`` writes the reference's schema-v1
RunRecord into it (``meta``, then ``round`` and ``eval`` events, then
``summary``; ``FedSimConfig.record_dir`` persists it as JSONL beside a
Chrome trace). With ``FedSimConfig.taps`` on, each round computes its
metric taps on the device (per-client train loss, EM weight entropy, link
success rate, effective neighbours). The fused engine packs them with the
block's accuracies and π into one tensor and copies it to the host once a
block, so recording adds no host sync; the legacy engine reads them back
each round, as the reference's does. The first block of each (method,
block length) on an instance records a ``compile`` event: the seconds
spent getting the method's kernels built or loaded, and the block's
matmul work from :meth:`FederatedSimulation.block_cost`.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import obs
from repro_torch.configs.base import PFLConfig
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core import aggregation, baselines
from repro_torch.core.pfedwn import (ModelFns, effective_neighbors,
                                     em_refine_loop, pi_entropy)
from repro_torch.core.selection import link_success_mask, link_success_rate
from repro_torch.data.synthetic import SyntheticImageDataset, stack_datasets
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import cnn
from repro_torch.sharding import (ClientGroup, client_group, join_slabs,
                                  take_slab)
from repro_torch.utils.bridge import ParamLayout

METHODS = ("local", "fedavg", "fedprox", "perfedavg", "fedamp", "pfedwn")
# the dispatches of a legacy round after its index draw, counted as the
# reference's legacy engine counts them (fedsim.py ``_run_legacy``)
_LEGACY_CALLS = {"local": 1, "fedavg": 3, "fedprox": 4, "perfedavg": 3,
                 "fedamp": 3, "pfedwn": 5}
# the CUDA kernels each method's round launches (``kernels/csrc``)
_METHOD_KERNELS = {"pfedwn": ("em_posterior", "weighted_agg")}
# the per-round scalars beside the train-loss row, in their packed order
_TAP_SCALARS = ("em_entropy", "link_success_rate", "effective_neighbors")
_F32 = 4                            # bytes an element: the engine is fp32


@dataclass
class FedSimConfig:
    rounds: int = 50
    batch_size: int = 64
    lr: float = 0.05
    alpha: float = 0.5                 # Eq (1) self-weight
    em_iters: int = 5
    em_component_steps: int = 1
    em_subset: int = 512               # target samples driving the EM E-step
    adapt_subset: int = 256            # Per-FedAvg eval-time adaptation set
    prox_mu: float = 0.1               # FedProx (and FedAMP's pull)
    maml_inner_lr: float = 0.01        # Per-FedAvg
    fedamp_sigma: float = 1e4
    fedamp_self_weight: float = 0.5
    erasures: bool = True              # re-sample link failures each round
    eval_every: int = 1
    seed: int = 0
    fused: bool = True                 # False: the legacy host-driven loop
    sharded: bool = False              # the client-sharded engine (wins)
    shard_devices: Optional[int] = None  # its ranks (None: the world size)
    em_uniform: bool = False           # ablation: uniform π instead of EM
    taps: bool = True                  # per-round metric taps
    record_dir: Optional[str] = None   # persist RunRecord JSONL + trace here
    run_name: Optional[str] = None     # record file stem (default: derived)


class Shard(NamedTuple):
    """The clients one rank of the sharded engine holds."""
    group: Any                 # the "clients" process group (None: D = 1)
    offset: int                # its first client
    size: int                  # S, its client count
    weights: torch.Tensor      # (S,) its slice of the global FedAvg weights


def block_schedule(rounds: int, eval_every: int) -> List[int]:
    """Round-block lengths between host syncs: evaluate after round r when
    ``r % eval_every == 0`` or ``r == rounds - 1``, so blocks are
    [1, eval_every, ..., tail]."""
    evals = sorted(set(range(0, rounds, max(eval_every, 1))) | {rounds - 1})
    blocks, prev = [], -1
    for r in evals:
        blocks.append(r - prev)
        prev = r
    return blocks


def cnn_fns(layout: ParamLayout) -> ModelFns:
    """The CNN's :class:`ModelFns` over flat (N, P) buffers of ``layout``."""
    def logits(flat, x):
        return cnn.apply_stacked(layout.views(flat), x)

    def per_sample_loss(flat, x, y):
        return cnn.per_sample_nll_stacked(layout.views(flat), x, y)

    def loss(flat, x, y):
        return torch.mean(per_sample_loss(flat, x, y), dim=-1)

    def accuracy(flat, x, y, mask):
        return cnn.masked_accuracy_stacked(layout.views(flat), x, y, mask)

    return ModelFns(logits=logits, per_sample_loss=per_sample_loss,
                    loss=loss, accuracy=accuracy)


class FederatedSimulation:
    """Target client = index 0; clients 1..N-1 are its candidate
    neighbours, of which the participants are the selected ones."""

    def __init__(self, model_cfg: CNNConfig,
                 train_sets: List[SyntheticImageDataset],
                 test_sets: List[SyntheticImageDataset],
                 participant_mask: np.ndarray,     # (N,) bool, incl. target
                 p_err: np.ndarray,                # (N,) target-link P_err
                 sim: FedSimConfig, *,
                 params0: Optional[torch.Tensor] = None,
                 device: str | torch.device = "cuda",
                 recorder: Optional[obs.RunRecorder] = None):
        """``params0``: initial (N, P) params (e.g. the reference's, through
        :func:`repro_torch.utils.bridge.from_jax_params`); drawn from a
        generator seeded with ``sim.seed`` when None. ``recorder``: where
        runs are recorded; an in-memory one (persisted under
        ``sim.record_dir`` when set, on rank 0 only) when None. Under the
        sharded engine in a started process group, ``device="cuda"`` means
        card rank mod the card count."""
        self.device = resolve_device(device)
        self.model_cfg, self.sim = model_cfg, sim
        self._rank = (dist.get_rank() if sim.sharded and dist.is_available()
                      and dist.is_initialized() else 0)
        if self.device.type == "cuda" and self.device.index is None and \
                sim.sharded:
            self.device = torch.device(
                "cuda", self._rank % torch.cuda.device_count())
        self.n = len(train_sets)
        self._group: Optional[ClientGroup] = None  # made on a sharded run
        self._shard: Optional[Shard] = None
        self.recorder = recorder or self._default_recorder()
        self._compiled: set = set()        # (method, block length) recorded
        self.train_sets, self.test_sets = train_sets, test_sets
        self.layout = cnn.param_layout(model_cfg)
        self.fns = cnn_fns(self.layout)
        pm = np.asarray(participant_mask, bool)
        if pm.shape != (self.n,) or np.shape(p_err) != (self.n,):
            raise ValueError(f"participant_mask and p_err must be "
                             f"({self.n},)")
        self.participants = torch.as_tensor(pm, device=self.device)
        self.sizes = torch.tensor([float(len(d)) for d in train_sets],
                                  dtype=torch.float32, device=self.device)
        self.neighbor_idx = np.where(pm & (np.arange(self.n) != 0))[0]
        self.m = len(self.neighbor_idx)
        self._nbr = torch.as_tensor(self.neighbor_idx, dtype=torch.int64,
                                    device=self.device)
        self._p_err_nbr = torch.as_tensor(
            np.asarray(p_err, np.float32)[self.neighbor_idx],
            device=self.device)
        if params0 is None:
            gen = torch.Generator(self.device).manual_seed(sim.seed)
            params0 = cnn.init_params(model_cfg, gen, self.n,
                                      device=self.device)
        params0 = torch.as_tensor(params0, dtype=torch.float32,
                                  device=self.device)
        if tuple(params0.shape) != (self.n, self.layout.size):
            raise ValueError(f"params0 must be ({self.n}, "
                             f"{self.layout.size}), got "
                             f"{tuple(params0.shape)}")
        self.params0 = params0
        self.last_state: Optional[Dict[str, torch.Tensor]] = None
        self.last_run_stats: Dict[str, Any] = {}
        self._stage_data()

    @property
    def engine(self) -> str:
        """The engine ``run`` takes: ``sharded`` wins over ``fused`` and
        ``legacy``."""
        if self.sim.sharded:
            return "sharded"
        return "fused" if self.sim.fused else "legacy"

    def _default_recorder(self) -> obs.RunRecorder:
        """In-memory RunRecorder, persisted when ``record_dir`` is set (by
        rank 0 alone under the sharded engine)."""
        sim = self.sim
        jsonl = trace = None
        if sim.record_dir and self._rank == 0:
            name = (sim.run_name
                    or f"fedsim_{self.engine}_N{self.n}_seed{sim.seed}")
            jsonl = os.path.join(sim.record_dir, f"{name}.jsonl")
            trace = os.path.join(sim.record_dir, f"{name}.trace.json")
        return obs.RunRecorder(jsonl_path=jsonl, trace_path=trace)

    # ------------------------------------------------------------- staging

    def _stage_data(self) -> None:
        """Move every tensor the round loop needs to the device, once."""
        with self.recorder.span("stage_data", n_clients=self.n):
            self._stage_data_inner()

    def _stage_data_inner(self) -> None:
        sim, dev = self.sim, self.device
        tx, ty, tlen, _ = stack_datasets(self.train_sets)
        self._train_len = np.maximum(tlen.astype(np.int64), 1)
        self._train_len_dev = torch.as_tensor(self._train_len, device=dev)
        if self.engine == "sharded":
            # the client stacks wait for the group (_stage_sharded); every
            # rank holds the target's own train row for its replicated pass
            self._shard = None
            self._train_x = self._train_y = None
            self._test_x = self._test_y = self._test_mask = None
            self._train_x0 = torch.as_tensor(tx[0], device=dev)
            self._train_y0 = torch.as_tensor(ty[0], dtype=torch.int64,
                                             device=dev)
        else:
            self._train_x = torch.as_tensor(tx, device=dev)
            self._train_y = torch.as_tensor(ty, dtype=torch.int64,
                                            device=dev)
            ex, ey, _, emask = stack_datasets(self.test_sets)
            self._test_x = torch.as_tensor(ex, device=dev)
            self._test_y = torch.as_tensor(ey, dtype=torch.int64, device=dev)
            self._test_mask = torch.as_tensor(emask, device=dev)
        # the E-step and Per-FedAvg's eval-time adaptation run on the
        # target's first em_subset / adapt_subset *unpadded* samples
        d0 = self.train_sets[0]
        self._em_x = torch.as_tensor(d0.x[:sim.em_subset], device=dev)
        self._em_y = torch.as_tensor(d0.y[:sim.em_subset], dtype=torch.int64,
                                     device=dev)
        self._adapt_x = torch.as_tensor(d0.x[:sim.adapt_subset], device=dev)
        self._adapt_y = torch.as_tensor(d0.y[:sim.adapt_subset],
                                        dtype=torch.int64, device=dev)
        max_k = max(len(d) for d in self.train_sets)
        self.steps_per_round = max(1, int(np.ceil(max_k / sim.batch_size)))

    def restrict_target_train(self, keep: int) -> None:
        """Shrink the target's train set to its first ``keep`` samples (the
        data-poor-target ablations) and restage. Keeping fewer than
        ``em_subset`` samples shrinks the EM set with it."""
        d = self.train_sets[0]
        d.x, d.y = d.x[:keep], d.y[:keep]
        self.sizes[0] = float(len(d))
        self.invalidate_caches()

    def invalidate_caches(self) -> None:
        """Restage the device tensors: call after mutating ``self.sim`` or
        a dataset in place. The next block of each (method, length) records
        its compile event again."""
        self._stage_data()
        self._compiled.clear()

    # ------------------------------------------------------ sharded engine

    def _client_group_info(self) -> ClientGroup:
        """The ``"clients"`` group of ``sim.shard_devices`` ranks (the
        reference's ``_client_mesh_info``), made on the first sharded run
        and kept. Raises ValueError when D does not divide N or exceeds the
        world size."""
        if self._group is None:
            self._group = client_group(self.n, self.sim.shard_devices)
        return self._group

    def _stage_sharded(self) -> Shard:
        """This rank's slabs of the padded train and test stacks, staged on
        its device once (the stacks are padded over all N clients first,
        as the reference pads them before partitioning), and its slice of
        the globally normalised FedAvg weights."""
        g = self._client_group_info()
        if self._shard is None:
            ofs, dev = g.rank * g.s, self.device

            def put(a, dtype=None):
                return torch.as_tensor(take_slab(a, ofs, g.s), dtype=dtype,
                                       device=dev)

            with self.recorder.span("stage_sharded", n_clients=self.n):
                tx, ty, _, _ = stack_datasets(self.train_sets)
                ex, ey, _, emask = stack_datasets(self.test_sets)
                self._train_x, self._train_y = put(tx), put(ty, torch.int64)
                self._test_x, self._test_y = put(ex), put(ey, torch.int64)
                self._test_mask = put(emask)
            w = self.sizes * self.participants.float()
            w = w / torch.clamp(torch.sum(w), min=1e-30)
            self._shard = Shard(g.group, ofs, g.s, take_slab(w, ofs, g.s))
        return self._shard

    def initial_sharded_state(self):
        """(params, π) at round 0 on this rank: its (S, P) slab of the full
        ``params0`` (a copy) and uniform π, replicated."""
        shard = self._stage_sharded()
        params = take_slab(self.params0, shard.offset, shard.size).clone()
        pi = torch.full((self.m,), 1.0 / max(self.m, 1), dtype=torch.float32,
                        device=self.device)
        return params, pi

    # ---------------------------------------------------------- round math

    def _draw_idx(self, gen: torch.Generator) -> torch.Tensor:
        """(N, steps, B) with-replacement minibatch indices, drawn on the
        device, client n's from [0, len_n)."""
        u = torch.rand((self.n, self.steps_per_round, self.sim.batch_size),
                       generator=gen, device=self.device)
        n = self._train_len_dev[:, None, None]
        return torch.minimum((u * n).long(), n - 1)

    def _sgd_step(self, objective):
        """An SGD step on ``objective(params, xb, yb) -> (K,)``; the summed
        objective gives each client the gradient of its own."""
        lr = self.sim.lr

        def step(params, xb, yb):
            loss, g = baselines.loss_and_grad(objective, params, xb, yb)
            return params.detach() - lr * g, loss
        return step

    def _sgd(self, params: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             idx: torch.Tensor, step=None):
        """Local training for K clients at once: params (K, P), data (K,
        K_max, ...), idx (K, steps, B). Each minibatch goes through
        ``step(params, xb, yb) -> (params, (K,) loss)``, an SGD step on the
        mean minibatch loss when None. Returns (params, (K,) mean of the
        steps' losses, or None with the taps off)."""
        step = step or self._sgd_step(self.fns.loss)
        rows = torch.arange(params.shape[0], device=self.device)[:, None]
        losses = []
        for s in range(idx.shape[1]):
            it = idx[:, s]
            params, step_loss = step(params, x[rows, it], y[rows, it])
            losses.append(step_loss)
        if not self.sim.taps:
            return params, None
        return params, torch.mean(torch.stack(losses), dim=0)

    def _round(self, method: str, params: torch.Tensor, pi: torch.Tensor,
               x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
               link_ok: Optional[torch.Tensor],
               shard: Optional[Shard] = None):
        """One round of ``method`` (the reference's round body), training
        on the minibatches at positions ``idx`` (N, steps, B) of ``x`` (N,
        K, ...) and ``y`` (N, K); returns (params, π, tap dict of device
        scalars, None with the taps off).

        Under the sharded engine (``shard`` given) ``params``, ``x`` and
        ``y`` are this rank's slabs and ``idx`` is the full draw, of which
        the rank takes its slab; the cross-client reads become the
        aggregation collectives, the target's math runs on every rank, and
        only the rank holding client 0 writes it back. The train-loss tap
        is then the rank's slab."""
        sim, fns, pm = self.sim, self.fns, self.participants
        if shard is None:
            pm_l, idx_l, x0, y0 = pm, idx, x[:1], y[:1]
            holds_target = True

            def mean(p):
                return baselines.fedavg_aggregate(p, self.sizes, pm)

            def gather(p):
                return p
        else:
            ofs, size = shard.offset, shard.size
            pm_l, idx_l = take_slab(pm, ofs, size), take_slab(idx, ofs, size)
            x0, y0 = self._train_x0[None], self._train_y0[None]
            holds_target = ofs == 0

            def mean(p):
                return aggregation.client_weighted_mean(p, shard.weights,
                                                        shard.group)

            def gather(p):
                return aggregation.gather_clients(p, shard.group)
        step = None
        if method == "fedprox":
            # the anchor is the global model *before* local training; one
            # pass over all clients, the pull gated by participation
            with record_function("fedsim.aggregate"):
                anchor = mean(params)
            active = pm_l.float()
            step = self._sgd_step(
                lambda p, xb, yb: fns.loss(p, xb, yb) + active
                * baselines.prox_term(p, anchor, sim.prox_mu))
        elif method == "fedamp":
            # clouds from the round's starting params; a non-participant's
            # cloud is its own start; a rank computes its slab's rows
            with record_function("fedsim.aggregate"):
                allp = gather(params)
                xi = baselines.fedamp_weights(allp, sim.fedamp_sigma, pm,
                                              sim.fedamp_self_weight)
                if shard is not None:
                    xi = take_slab(xi, shard.offset, shard.size)
                cloud = baselines.fedamp_cloud_models(allp, xi)
            step = self._sgd_step(
                lambda p, xb, yb: fns.loss(p, xb, yb)
                + baselines.prox_term(p, cloud, sim.prox_mu))
        elif method == "perfedavg":
            # first-order MAML on the batch's halves (the query half takes
            # the odd sample); the step's loss is the query loss
            half = sim.batch_size // 2

            def step(p, xb, yb):
                return baselines.perfedavg_step(
                    fns.loss, p, xb[:, :half], yb[:, :half], xb[:, half:],
                    yb[:, half:], sim.maml_inner_lr, sim.lr)
        with record_function("fedsim.local_sgd"):
            params, train_loss = self._sgd(params, x, y, idx_l, step)
        if method in ("fedavg", "fedprox", "perfedavg"):
            with record_function("fedsim.aggregate"):
                g = mean(params)
                params = baselines.broadcast_global(g, params, pm_l)
        if method == "pfedwn":
            # the peer stack, gathered once a round under the sharded engine
            allp = gather(params)
            if sim.em_uniform:
                pi = torch.full((self.m,), 1.0 / max(self.m, 1),
                                dtype=torch.float32, device=self.device)
            else:
                # EM refines copies of the neighbours (the advanced index
                # copies); Eq 1 mixes the unrefined rows of the stack
                with record_function("fedsim.em"):
                    _, pi, _ = em_refine_loop(
                        fns, allp[self._nbr], pi, self._em_x, self._em_y,
                        iters=sim.em_iters, lr=sim.lr,
                        min_weight=PFLConfig().em_min_weight,
                        component_steps=sim.em_component_steps)
            with record_function("fedsim.mix"):
                mixed = aggregation.mix_flat_with_erasures(
                    allp, 0, self._nbr, pi, sim.alpha, link_ok)
            # the target's pass after aggregation reuses round's idx[0]
            with record_function("fedsim.target_sgd"):
                mixed, loss0 = self._sgd(mixed[None], x0, y0, idx[:1])
            if holds_target:
                params[0] = mixed[0]
        if not sim.taps:
            return params, pi, None
        link_rate = torch.ones((), device=self.device)
        eff_nbr = torch.clamp(torch.sum(pm.float()) - 1.0, min=0.0)
        if method == "local":
            eff_nbr = torch.zeros((), device=self.device)
        elif method == "pfedwn":
            # the target's entry tracks its pass after aggregation
            if holds_target:
                train_loss[0] = loss0[0]
            link_rate = link_success_rate(link_ok)
            eff_nbr = effective_neighbors(pi, link_ok)
        tap = {"train_loss": train_loss, "em_entropy": pi_entropy(pi),
               "link_success_rate": link_rate,
               "effective_neighbors": eff_nbr}
        return params, pi, tap

    @torch.no_grad()
    def _eval(self, method: str, params: torch.Tensor,
              shard: Optional[Shard] = None):
        """(target accuracy, mean participant accuracy) on the padded test
        stacks, as device scalars. Per-FedAvg's target is scored after one
        MAML step on its adaptation set; the mean scores every participant
        unadapted. Under the sharded engine: (target accuracy, 0 on a rank
        that does not hold the target; the sum of the slab's participant
        accuracies)."""
        accs = self.fns.accuracy(params, self._test_x, self._test_y,
                                 self._test_mask)
        pmf = self.participants.float()
        if shard is not None:
            pmf = take_slab(pmf, shard.offset, shard.size)
        holds_target = shard is None or shard.offset == 0
        t_acc = accs[0] if holds_target else accs.new_zeros(())
        if method == "perfedavg" and holds_target:
            tgt = baselines.maml_adapt(self.fns.loss, params[:1],
                                       self._adapt_x[None],
                                       self._adapt_y[None],
                                       self.sim.maml_inner_lr)
            t_acc = self.fns.accuracy(tgt, self._test_x[:1],
                                      self._test_y[:1],
                                      self._test_mask[:1])[0]
        acc_sum = torch.sum(accs * pmf)
        if shard is not None:
            return t_acc, acc_sum
        return t_acc, acc_sum / torch.clamp(torch.sum(pmf), min=1.0)

    def _exchange_block(self, shard: Shard, t_acc: torch.Tensor,
                        acc_sum: torch.Tensor, pi: torch.Tensor,
                        rows: List[torch.Tensor],
                        length: int) -> torch.Tensor:
        """The sharded block's one small exchange: every rank's target
        accuracy (0 off the target's rank), its participants' accuracy sum
        and, a round, its train-loss slab and the three tap scalars, all
        gathered at once; returned laid out as the fused engine packs its
        block (target accuracy, mean participant accuracy, π, the rounds'
        taps), still on the device."""
        local = torch.cat([torch.stack([t_acc, acc_sum])] + rows)
        allb = aggregation.exchange_block(local, shard.group)   # (D, K)
        mean = torch.sum(allb[:, 1]) / torch.clamp(
            torch.sum(self.participants.float()), min=1.0)
        packed = [allb[0, :1], mean[None], pi]     # rank 0 holds client 0
        if rows:
            s = shard.size
            taps = allb[:, 2:].reshape(allb.shape[0], length, s + 3)
            loss = join_slabs(taps[:, :, :s].unbind(0), client_axis=1)
            packed.append(torch.cat([loss, taps[0, :, s:]], 1).reshape(-1))
        return torch.cat(packed)

    @torch.no_grad()
    def _eval_legacy(self, method: str, params: torch.Tensor):
        """The legacy engine's evaluation, host-driven as the reference's:
        the target (Per-FedAvg's after one MAML step on its adaptation
        set), then each participant in turn, each on its unpadded test set
        uploaded for the call and read back. Returns (target accuracy, mean
        participant accuracy, participants scored)."""
        dev, fns = self.device, self.fns

        def accuracy(row: torch.Tensor, d: SyntheticImageDataset) -> float:
            x = torch.as_tensor(d.x, device=dev)[None]
            y = torch.as_tensor(d.y, dtype=torch.int64, device=dev)[None]
            ones = torch.ones(y.shape, dtype=torch.bool, device=dev)
            return float(fns.accuracy(row, x, y, ones)[0])

        tgt = params[:1]
        if method == "perfedavg":
            d0, k = self.train_sets[0], self.sim.adapt_subset
            tgt = baselines.maml_adapt(
                fns.loss, tgt, torch.as_tensor(d0.x[:k], device=dev)[None],
                torch.as_tensor(d0.y[:k], dtype=torch.int64,
                                device=dev)[None], self.sim.maml_inner_lr)
        t_acc = accuracy(tgt, self.test_sets[0])
        accs = [accuracy(params[i:i + 1], self.test_sets[i])
                for i in np.where(self.participants.cpu().numpy())[0]]
        mean = float(np.mean(accs)) if accs else float("nan")
        return t_acc, mean, len(accs)

    # ---------------------------------------------------- compile events

    def _pass_cost(self, models: int, samples: int, backward: bool):
        """(FLOPs, bytes) of the CNN's matmuls for ``models`` models over
        ``samples`` samples each: the forward, and with ``backward`` its
        backward (two matmuls a layer, one at the first, whose input needs
        no gradient)."""
        flops = nbytes = 0
        for i, (r, k, n) in enumerate(cnn.matmul_shapes(self.model_cfg)):
            mults = 1 + ((2 if i else 1) if backward else 0)
            rows = samples * r
            flops += mults * 2 * models * rows * k * n
            nbytes += mults * _F32 * models * (rows * k + k * n + rows * n)
        return flops, nbytes

    def block_cost(self, method: str, length: int) -> Dict[str, float]:
        """The matmul work of one fused block of ``length`` rounds of
        ``method`` and its eval: ``{"flops", "bytes_accessed"}``.

        With the CNN's matmuls (r rows a sample, k, n) from
        :func:`repro_torch.models.cnn.matmul_shapes`, a forward of K models
        over S samples each is F(K, S) = Σ 2·K·S·r·k·n FLOPs and moves
        Σ 4·K·(S·r·k + k·n + S·r·n) bytes (fp32 operands read once, the
        output written once); a forward and backward, G(K, S), counts
        every layer three times but the first twice. With N clients,
        steps s and batch B a round, M neighbours, P params, EM on n_em
        samples for I iterations of c component steps, T padded test rows
        and A adaptation samples, a round is

          s·G(N, B)                      every method's local SGD
          (Per-FedAvg: s·(G(N, ⌊B/2⌋) + G(N, ⌈B/2⌉)), its two half-batches)
          + 2·N·P a FedAvg aggregate     (FedAvg, Per-FedAvg 1; FedProx 2)
          + 4·N²·P                       (FedAMP: the Gram W·Wᵀ, ξ·W)
          + pFedWN: (I−1)·c·G(M, n_em) + F(M, n_em) for EM (F(M, n_em)
            alone with c = 0, nothing under ``em_uniform``), 2·M·P for
            the Eq-1 mix, and s·G(1, B) for the target's pass

        and the eval is F(N, T), plus G(1, A) + F(1, T) for Per-FedAvg's
        adapted target. A product u·W of a length-R vector with an (R, P)
        matrix moves 4·(R + R·P + P) bytes. This is the work of the
        matmuls only (the counts ``torch.utils.flop_counter`` gives), not
        an XLA-style estimate with the elementwise work in it.

        Under the sharded engine it is one rank's work: its S clients take
        N's place in the local SGD, the FedAvg contractions, FedAMP's
        clouds (2·S·N·P after the Gram of all N) and the eval; the target's
        math is on every rank, and Per-FedAvg's adaptation on the rank that
        holds the target only."""
        sim, n, m = self.sim, self.n, self.m
        k, holds_target = n, True     # the clients this process trains
        if self.engine == "sharded":
            shard = self._stage_sharded()
            k, holds_target = shard.size, shard.offset == 0
        p = self.layout.size
        steps, b = self.steps_per_round, sim.batch_size
        flops = nbytes = 0

        def add(cost, times=1):
            nonlocal flops, nbytes
            flops += times * cost[0]
            nbytes += times * cost[1]

        def vec_mat(rows, times=1):     # (rows,) @ (rows, P)
            add((2 * rows * p, _F32 * (rows + rows * p + p)), times)

        if method == "perfedavg":
            add(self._pass_cost(k, b // 2, True), steps)
            add(self._pass_cost(k, b - b // 2, True), steps)
        else:
            add(self._pass_cost(k, b, True), steps)
        if method in ("fedavg", "perfedavg"):
            vec_mat(k)
        elif method == "fedprox":
            vec_mat(k, 2)
        elif method == "fedamp":
            add((2 * n * n * p, _F32 * (2 * n * p + n * n)))
            add((2 * k * n * p, _F32 * (k * n + n * p + k * p)))
        elif method == "pfedwn":
            n_em = self._em_x.shape[0]
            if not sim.em_uniform and sim.em_iters > 0:
                if sim.em_component_steps > 0:
                    add(self._pass_cost(m, n_em, True),
                        (sim.em_iters - 1) * sim.em_component_steps)
                add(self._pass_cost(m, n_em, False))
            vec_mat(m)
            add(self._pass_cost(1, b, True), steps)
        flops, nbytes = length * flops, length * nbytes
        t = self._test_x.shape[1]
        add(self._pass_cost(k, t, False))
        if method == "perfedavg" and holds_target:
            add(self._pass_cost(1, self._adapt_x.shape[0], True))
            add(self._pass_cost(1, t, False))
        return {"flops": float(flops), "bytes_accessed": float(nbytes)}

    def _compile_event(self, method: str, length: int) -> None:
        """On the first block of each (method, length): get the method's
        kernels built or loaded, and record it as a compile event (0.0 s
        on the CPU, where no kernel runs) with the block's cost."""
        key = (method, int(length))
        if key in self._compiled:
            return
        t0 = time.perf_counter()
        with self.recorder.span("compile", cat="compile", method=method,
                                rounds=length):
            names = _METHOD_KERNELS.get(method, ())
            if self.device.type == "cuda" and names:
                _build.build(names)        # one nvcc each, together
                for name in names:
                    _build.load(name)
        seconds = (time.perf_counter() - t0 if self.device.type == "cuda"
                   else 0.0)
        self.recorder.record_compile(f"{method}/block{length}",
                                     cost=self.block_cost(method, length),
                                     seconds=seconds)
        self._compiled.add(key)

    # ---------------------------------------------------------------- entry

    def _injected(self, idx_stream, link_masks):
        sim = self.sim
        idx = masks = None
        if idx_stream is not None:
            idx_np = np.asarray(idx_stream)
            want = (sim.rounds, self.n, self.steps_per_round, sim.batch_size)
            if idx_np.shape != want:
                raise ValueError(f"idx_stream must be {want}, got "
                                 f"{idx_np.shape}")
            if idx_np.min() < 0 or np.any(
                    idx_np.max(axis=(0, 2, 3)) >= self._train_len):
                raise ValueError("idx_stream indexes past a client's data")
            idx = torch.as_tensor(idx_np, dtype=torch.int64,
                                  device=self.device)
        if link_masks is not None:
            masks_np = np.asarray(link_masks, bool)
            if masks_np.shape != (sim.rounds, self.m):
                raise ValueError(f"link_masks must be ({sim.rounds}, "
                                 f"{self.m}), got {masks_np.shape}")
            masks = torch.as_tensor(masks_np, device=self.device)
        return idx, masks

    def _link_ok(self, method: str, gen: torch.Generator, masks, rnd: int
                 ) -> Optional[torch.Tensor]:
        """pFedWN's link mask for round ``rnd``, drawn after the round's
        indices: every link up with ``erasures`` off, else the injected
        mask or a draw from ``gen``; None for the other methods."""
        if method != "pfedwn":
            return None
        if not self.sim.erasures:
            return torch.ones((self.m,), dtype=torch.bool, device=self.device)
        if masks is not None:
            return masks[rnd]
        return link_success_mask(self._p_err_nbr, gen)

    def _host_batches(self, idx: torch.Tensor):
        """The legacy engine's per-round transfer: the round's indices (N,
        steps, B) brought to the host, every client's minibatches gathered
        there from its dataset with numpy and uploaded as x (N, steps·B,
        ...) and y (N, steps·B), with the positions (N, steps, B) that walk
        them in order."""
        idx_np = idx.cpu().numpy()
        n, steps, b = idx_np.shape
        xs = np.stack([d.x[idx_np[i]] for i, d in enumerate(self.train_sets)])
        ys = np.stack([d.y[idx_np[i]] for i, d in enumerate(self.train_sets)])
        x = torch.as_tensor(xs.reshape((n, steps * b) + xs.shape[3:]),
                            device=self.device)
        y = torch.as_tensor(ys.reshape(n, steps * b), dtype=torch.int64,
                            device=self.device)
        pos = torch.arange(steps * b, device=self.device).view(1, steps, b)
        return x, y, pos.expand(n, -1, -1)

    def run(self, method: str, *, idx_stream=None,
            link_masks=None) -> Dict[str, Any]:
        """Run ``sim.rounds`` rounds of ``method`` from ``params0`` on the
        engine ``sim.sharded`` and ``sim.fused`` select (:attr:`engine`),
        recording it in ``self.recorder``. Under the sharded engine every
        rank of the client group calls it with the same arguments.

        ``idx_stream`` (rounds, N, steps, B) and ``link_masks`` (rounds, M)
        replace the on-device draws when given; with ``sim.erasures`` off
        every link succeeds, injected masks or not. Returns the reference's
        history dict (``target_acc``, ``mean_participant_acc``, ``pi`` per
        eval point, ``max_target_acc``) plus ``taps`` (per-round metrics as
        numpy arrays; empty with ``sim.taps`` off) and ``round_ms`` (host
        ms per round, eval included: of each block on the fused engine, of
        each round on the legacy one). The final params (this rank's slab
        under the sharded engine) and π are left in ``self.last_state``,
        and ``self.last_run_stats`` holds the engine and its
        ``device_calls``: the fused and sharded engines' host syncs (one
        per block), or the dispatches the legacy engine drives, counted as the
        reference counts its own."""
        method = method.lower()
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; have {METHODS}")
        sim, rec, engine = self.sim, self.recorder, self.engine
        idx_all, masks_all = self._injected(idx_stream, link_masks)
        rec.begin_run(method=method, engine=engine, meta={
            "n_clients": self.n, "rounds": sim.rounds,
            "eval_every": sim.eval_every, "batch_size": sim.batch_size,
            "lr": sim.lr, "seed": sim.seed, "taps": sim.taps,
            "steps_per_round": self.steps_per_round})
        gen = torch.Generator(self.device).manual_seed(sim.seed + 7)
        if engine == "sharded":
            params, pi = self.initial_sharded_state()
        else:
            params = self.params0.clone()
            pi = torch.full((self.m,), 1.0 / max(self.m, 1),
                            dtype=torch.float32, device=self.device)
        run = self._run_legacy if engine == "legacy" else self._run_fused
        history = run(method, gen, params, pi, idx_all, masks_all)
        rec.end_run(method=method, engine=engine, rounds=sim.rounds,
                    max_target_acc=history["max_target_acc"],
                    final_target_acc=history["target_acc"][-1],
                    extra={"device_calls":
                           self.last_run_stats["device_calls"]})
        return history

    def _run_fused(self, method: str, gen: torch.Generator,
                   params: torch.Tensor, pi: torch.Tensor, idx_all,
                   masks_all) -> Dict[str, Any]:
        """The fused loop, shared with the sharded engine: blocks of rounds
        between eval points, each ending in one host copy of the block's
        accuracies, π and taps (sharded: after the block's one small
        exchange across the ranks)."""
        sim, rec, n, m = self.sim, self.recorder, self.n, self.m
        shard = self._stage_sharded() if self.engine == "sharded" else None
        history: Dict[str, Any] = {"target_acc": [], "pi": [],
                                   "mean_participant_acc": [],
                                   "round_ms": []}
        taps: Dict[str, list] = {}
        rnd = 0
        blocks = block_schedule(sim.rounds, sim.eval_every)
        for length in blocks:
            self._compile_event(method, length)
            t0 = time.perf_counter()
            with rec.span("block_exec", method=method, rounds=length):
                rows = []               # each round's taps, packed
                for r in range(rnd, rnd + length):
                    idx = (self._draw_idx(gen) if idx_all is None
                           else idx_all[r])
                    link_ok = self._link_ok(method, gen, masks_all, r)
                    params, pi, tap = self._round(
                        method, params, pi, self._train_x, self._train_y,
                        idx, link_ok, shard)
                    if tap is not None:
                        rows += [tap["train_loss"],
                                 torch.stack([tap[k] for k in _TAP_SCALARS])]
                with record_function("fedsim.eval"):
                    t_acc, mean_acc = self._eval(method, params, shard)
                if shard is None:
                    packed = torch.cat([torch.stack([t_acc, mean_acc]), pi]
                                       + rows)
                else:
                    packed = self._exchange_block(shard, t_acc, mean_acc, pi,
                                                  rows, length)
                # the one host sync of the block
                host = packed.cpu().numpy()
            ms = (time.perf_counter() - t0) / length * 1e3
            history["round_ms"].append(ms)
            rec.observe_round_latency(ms, n=length)
            t_acc, mean_acc = float(host[0]), float(host[1])
            pi_host = host[2:2 + m]
            with rec.span("drain", method=method, rounds=length):
                if sim.taps:
                    block = host[2 + m:].reshape(length, n + 3)
                    taps.setdefault("train_loss", []).append(block[:, :n])
                    for j, k in enumerate(_TAP_SCALARS):
                        taps.setdefault(k, []).append(block[:, n + j])
                    for i in range(length):
                        rec.record_round(
                            rnd + i, train_loss=block[i, :n].tolist(),
                            em_entropy=float(block[i, n]),
                            link_success_rate=float(block[i, n + 1]),
                            effective_neighbors=float(block[i, n + 2]))
            rnd += length
            history["target_acc"].append(t_acc)
            history["mean_participant_acc"].append(mean_acc)
            if method == "pfedwn":
                history["pi"].append(pi_host.copy())
            rec.record_eval(rnd - 1, target_acc=t_acc,
                            mean_participant_acc=mean_acc,
                            pi=pi_host.tolist() if method == "pfedwn"
                            else None)
        history["max_target_acc"] = float(np.max(history["target_acc"]))
        history["taps"] = {k: np.concatenate(v) for k, v in taps.items()}
        self.last_state = {"params": params, "pi": pi}
        self.last_run_stats = {"engine": self.engine, "blocks": blocks,
                               "device_calls": len(blocks)}
        return history

    def _run_legacy(self, method: str, gen: torch.Generator,
                    params: torch.Tensor, pi: torch.Tensor, idx_all,
                    masks_all) -> Dict[str, Any]:
        """The legacy host-driven loop (the reference's ``_run_legacy``):
        one round at a time, its minibatches gathered on the host and
        uploaded, its taps read back and recorded, and the host-driven
        evaluation at the reference's eval points."""
        sim, rec = self.sim, self.recorder
        every = max(sim.eval_every, 1)
        history: Dict[str, Any] = {"target_acc": [], "pi": [],
                                   "mean_participant_acc": [],
                                   "round_ms": []}
        taps: Dict[str, list] = {}
        device_calls = 0
        for rnd in range(sim.rounds):
            t0 = time.perf_counter()
            idx = self._draw_idx(gen) if idx_all is None else idx_all[rnd]
            x, y, pos = self._host_batches(idx)
            link_ok = self._link_ok(method, gen, masks_all, rnd)
            params, pi, tap = self._round(method, params, pi, x, y, pos,
                                          link_ok)
            if tap is not None:
                host = {k: v.cpu().numpy() for k, v in tap.items()}
                for k, v in host.items():
                    taps.setdefault(k, []).append(v[None])
                rec.record_round(
                    rnd, train_loss=host["train_loss"].tolist(),
                    em_entropy=float(host["em_entropy"]),
                    link_success_rate=float(host["link_success_rate"]),
                    effective_neighbors=float(host["effective_neighbors"]))
            device_calls += 1 + _LEGACY_CALLS[method]
            if rnd % every == 0 or rnd == sim.rounds - 1:
                with rec.span("eval", method=method, round=rnd):
                    t_acc, mean_acc, scored = self._eval_legacy(method,
                                                                params)
                    device_calls += scored
                    history["target_acc"].append(t_acc)
                    history["mean_participant_acc"].append(mean_acc)
                    pi_host = (pi.cpu().numpy() if method == "pfedwn"
                               else None)
                    if pi_host is not None:
                        history["pi"].append(pi_host)
                    rec.record_eval(
                        rnd, target_acc=t_acc, mean_participant_acc=mean_acc,
                        pi=None if pi_host is None else pi_host.tolist())
            ms = (time.perf_counter() - t0) * 1e3
            history["round_ms"].append(ms)
            rec.observe_round_latency(ms)
        history["max_target_acc"] = float(np.max(history["target_acc"]))
        history["taps"] = {k: np.concatenate(v) for k, v in taps.items()}
        self.last_state = {"params": params, "pi": pi}
        self.last_run_stats = {"engine": "legacy",
                               "device_calls": device_calls}
        return history

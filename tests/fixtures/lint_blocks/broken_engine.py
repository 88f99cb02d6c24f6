"""A deliberately broken engine for ``repro_torch.lint.blocks``'s tests:
every SGD step makes a collective (the FedAvg-family mean), inside the
inner loop."""
import torch

from repro_torch.core import aggregation
from repro_torch.core.fedsim import FederatedSimulation
from repro_torch.lint.blocks import build_sim


class BrokenSimulation(FederatedSimulation):
    def _sgd_step(self, objective):
        step = super()._sgd_step(objective)
        group = self._shard.group if self._shard is not None else None

        def broken(params, xb, yb):
            w = torch.ones(params.shape[0], device=params.device)
            aggregation.client_weighted_mean(params, w, group)
            return step(params, xb, yb)
        return broken


def build(engine, devices, device):
    return build_sim(engine, devices, device, cls=BrokenSimulation)

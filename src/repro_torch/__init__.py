"""PyTorch + CUDA port of the pFedWN simulator (the JAX package ``repro`` is
the reference it is held against).

Module names mirror ``repro``'s so each counterpart is easy to find. The
package imports ``torch`` and numpy only: nothing of ``jax`` and nothing of
``repro``. Entry points take an explicit ``device`` that defaults to
``"cuda"`` and raise when no card is present; they run on the CPU only when
the caller passes ``device="cpu"``.

Every Pallas kernel of the reference has a hand-written CUDA C++
counterpart for Hopper (``kernels/csrc``): on the pFedWN round's path the
Eq-9 E-step (``kernels.em_posterior``) and the erasure-gated Eq-1 mix
(``kernels.weighted_agg``); on the language models' serving path
(``launch.serve``: prefill, then greedy decode) GQA flash attention
(``kernels.flash_attention``), which every layer's prefill attention runs.
LM training (``launch.train``: single-client, and federated pFedWN over LM
clients) runs that attention's forward and its hand-written backward in
every layer, and the Eq-1 mix once per param leaf.
"""
from repro_torch.device import disable_tf32, resolve_device

__all__ = ["disable_tf32", "resolve_device"]

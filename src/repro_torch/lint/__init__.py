"""Invariant checks of the port's engines: :mod:`.blocks` runs each
method's round blocks and checks their collectives, host syncs, kernel
launches, dtypes and FLOPs (``python -m repro_torch.lint.blocks``)."""

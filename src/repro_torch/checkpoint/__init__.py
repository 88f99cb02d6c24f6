from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]

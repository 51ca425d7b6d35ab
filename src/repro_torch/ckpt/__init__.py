from repro_torch.ckpt.checkpoint import CheckpointManager, save_pytree, restore_pytree  # noqa

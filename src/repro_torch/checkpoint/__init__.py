from repro_torch.checkpoint.checkpointer import carry_over, load_pytree, restore_latest

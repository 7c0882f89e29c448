from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    carry_over,
    load_into,
    load_pytree,
    restore_latest,
    save_pytree,
    verify,
)

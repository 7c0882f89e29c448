"""The model zoo's functional API (counterpart of ``repro/models/__init__.py``),
exported lazily as the reference does, so that importing a leaf module
(``models.layers``, ``models.ssm``) does not import the whole model."""
_EXPORTS = ("init_params", "forward", "loss_fn", "decode_step", "prefill", "init_cache",
            "write_prefill", "layer_plan", "frontend_dim")


def __getattr__(name):
    if name in _EXPORTS:
        from repro_torch.models import model as _m

        return getattr(_m, name)
    raise AttributeError(name)

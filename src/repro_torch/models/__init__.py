"""Models of the port. The names below load on first use, so that the
kernels' plain versions (``models.attention_ops``) import without pulling in
the model stack that calls the kernels."""
_EXPORTS = {"Model": "registry", "build_model": "registry",
            "params_from_jax": "registry", "LM": "lm"}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(
            f"repro_torch.models.{_EXPORTS[name]}"), name)
    raise AttributeError(name)

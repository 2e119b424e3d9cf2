"""Quality metrics of synthetic tables: statistical similarity and ML
utility.

The re-exports are lazy, as the JAX package's are
(``fed_tgan_tpu/eval/__init__.py``): ``python -m
fed_tgan_torch.eval.similarity`` would otherwise import the submodule
through this package first and trip runpy's already-in-``sys.modules``
warning."""


def __getattr__(name):
    import importlib

    if name in ("utility", "similarity"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in ("ml_utility", "utility_difference"):
        return getattr(importlib.import_module(f"{__name__}.utility"), name)
    if name in ("statistical_similarity", "similarity_report"):
        return getattr(importlib.import_module(f"{__name__}.similarity"), name)
    raise AttributeError(name)


__all__ = ["ml_utility", "similarity_report", "statistical_similarity",
           "utility_difference"]

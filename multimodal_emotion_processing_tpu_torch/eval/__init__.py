from .ensemble import Ensemble, apply_thresholds, threshold_sweep  # noqa: F401

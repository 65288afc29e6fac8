"""Optimization primitives for the autotuner: the port's copy of
``horovod_tpu/common/optim/`` (NumPy only; parity with Horovod's
``common/optim/``): Gaussian-process regression and expected-improvement
Bayesian optimization. The seeded ``RandomState`` stays, so the port's
tuner proposes the reference's candidates.
"""

from .bayesian_optimization import BayesianOptimization  # noqa: F401
from .gaussian_process import GaussianProcessRegressor  # noqa: F401

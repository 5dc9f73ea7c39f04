"""Gaussian-process edge tracing in JAX.

A from-scratch JAX/XLA re-design of ``jaburke166/gaussian_process_edge_trace``
(Burke & King, IEEE TIP 2022): the recursive-Bayesian edge tracer compiles to
a single XLA program of fixed-shape padded buffers, with Matheron pathwise
posterior sampling, dense linear-binning KDE, and vmapped curve scoring.

Public API mirrors the reference package (reference __init__.py:10-15):
``GP_Edge_Tracing``, ``GaussianProcessRegressor``, and ``gpet_utils``.
"""

from gaussian_process_edge_trace_tpu.utils import (  # noqa: F401
    kernel_builder, normalise, comp_grad_img, denoise,
    construct_test_img, trace_MSE, trace_relarea, trace_dicecoef)

__version__ = "0.1.0"

# Debug config (SURVEY §5 sanitizer row): GPET_DEBUG=1 enables
# jax_debug_nans at import; utils.debug has the scoped/manual knobs.
import os as _os

if _os.environ.get("GPET_DEBUG") == "1":
    from gaussian_process_edge_trace_tpu.utils.debug import enable_debug
    enable_debug()

__all__ = [
    "kernel_builder", "normalise", "comp_grad_img", "denoise",
    "construct_test_img", "trace_MSE", "trace_relarea", "trace_dicecoef",
]


def __getattr__(name):
    # Lazy imports keep `import gaussian_process_edge_trace_tpu` light and
    # avoid import cycles while the full surface is under construction.
    if name == "GP_Edge_Tracing":
        from gaussian_process_edge_trace_tpu.models.tracer import GP_Edge_Tracing
        return GP_Edge_Tracing
    if name == "GaussianProcessRegressor":
        from gaussian_process_edge_trace_tpu.models.sklearn_api import (
            GaussianProcessRegressor)
        return GaussianProcessRegressor
    if name == "gpet_utils":
        from gaussian_process_edge_trace_tpu import utils as gpet_utils
        return gpet_utils
    raise AttributeError(name)

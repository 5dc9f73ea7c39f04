"""Test configuration: an 8-device virtual CPU platform.

Tests need no accelerator; sharding tests use the virtual CPU mesh
(SURVEY.md §4: the analogue of a fake backend).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Oracle comparisons (scipy/sklearn) are f64; enable x64 so formula tests
# validate the math at full precision. The device path runs f32 — its
# accuracy is covered by the tolerance-based end-to-end parity tests.
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Also set through the config, in case a plugin imported jax before the
# environment variable above was set.
jax.config.update("jax_platforms", "cpu")

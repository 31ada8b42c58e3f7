"""Run the tests on a virtual 8-device CPU mesh: the slab-pipeline tests
need several devices, and the CPU results are the reference that
chip_smoke.py holds the GPU to. JAX_PLATFORMS and XLA_FLAGS must be set
before jax picks a backend; jax.config is updated too in case jax was
imported first."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# The 8 virtual devices share a few host cores with the other test workers;
# under load a collective's threads can arrive minutes apart, and XLA:CPU's
# default rendezvous timeout aborts the whole worker process.
if "collective_timeout" not in flags:
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
              " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
              " --xla_cpu_collective_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags.strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

assert all(d.platform == "cpu" for d in jax.devices()), (
    "tests must run on the virtual CPU mesh, got: " + str(jax.devices())
)
assert jax.device_count() >= 8, (
    "expected 8 virtual CPU devices, got " + str(jax.device_count())
)

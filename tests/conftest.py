"""Test harness: force an 8-device virtual CPU mesh before jax initialises.

Multi-chip sharding is validated on virtual CPU devices
(xla_force_host_platform_device_count), matching how the reference validated
its 'distributed' dataflow on localhost loopback (SURVEY.md section 4.5).
"""

import os

if not os.environ.get("WRP_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

if not os.environ.get("WRP_TEST_GPU"):
    assert jax.device_count() == 8, jax.devices()

REFERENCE = "/root/reference"


def cpu_subprocess_env(**extra):
    """Environment for a CPU-only wrp_tpu subprocess."""
    return dict(os.environ, JAX_PLATFORMS="cpu", **extra)


@pytest.fixture
def gpu_device():
    """The GPU for tests marked `gpu`; skips where there is none.  Decided
    here, at run time, never at import: the suite pins this process to
    the CPU, so the gpu tests run on the card with
    `WRP_TEST_GPU=1 python -m pytest -m gpu tests/` (README)."""
    if not os.environ.get("WRP_TEST_GPU"):
        pytest.skip("needs a GPU: run with WRP_TEST_GPU=1 -m gpu on the card")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def reference_dir():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference tree not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def golden_04abs(reference_dir):
    from wrp_tpu.io.files import read_ascii_matrix

    return read_ascii_matrix(os.path.join(reference_dir, "in/04abs.altb"))


@pytest.fixture(scope="session")
def golden_08pow(reference_dir):
    from wrp_tpu.io.files import read_ascii_matrix

    return read_ascii_matrix(os.path.join(reference_dir, "out/08pow.cpu.out"))


@pytest.fixture(scope="session")
def golden_09zdb(reference_dir):
    from wrp_tpu.io.files import read_ascii_matrix

    return read_ascii_matrix(os.path.join(reference_dir, "in/09zdb.altb")).ravel()


@pytest.fixture(scope="session")
def golden_10zdr(reference_dir):
    from wrp_tpu.io.files import read_ascii_matrix

    return read_ascii_matrix(os.path.join(reference_dir, "in/10zdr.altb")).ravel()


@pytest.fixture(scope="session")
def golden_result(reference_dir):
    from wrp_tpu.io.files import read_result_file

    return read_result_file(os.path.join(reference_dir, "out/99result.cpu.out"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)

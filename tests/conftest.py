import os
import pathlib
import tempfile

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic
# is exercised without an accelerator.  The config API pins the CPU even
# where JAX_PLATFORMS names another platform, unless it lists the CPU
# first and CUDA after it (`JAX_PLATFORMS=cpu,cuda`, for the `gpu` tests
# on a GPU machine): the CPU stays the default backend either way.
# Compiled programs are cached outside the checkout, so test runs do not
# grow it.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(
    tempfile.gettempdir(), "spasm_tests_jax_cache"))
import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS") != "cpu,cuda":
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

HERE = pathlib.Path(__file__).parent
MATRIX = HERE / "Matrix"
EXPECTED = HERE / "Expected"

# Same modulus grid as the reference test-suite
# (/root/reference/tests/CMakeLists.txt:46-53): hits the float / double /
# int64 datatype regimes of the reference and the 2^32-5 extreme.
ALL_MODULI = [3, 257, 65537, 67108859, 189812507, 4294967291]

SMALL_MODULI = [3, 257, 65537]


@pytest.fixture
def matrix_dir():
    return MATRIX


@pytest.fixture
def expected_dir():
    return EXPECTED


def fixture_path(name: str) -> pathlib.Path:
    return MATRIX / name


ALL_TEST_MATRICES = sorted(p.name for p in MATRIX.glob("*.sms")
                           if p.name not in ("trefethen_2000.sms",
                                             "tridiagonal.sms"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: large end-to-end instances (run explicitly or "
        "in full CI; deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (decided "
        "inside the `gpu_device` fixture)")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip.  Tests that need the card take
    this fixture (and carry the `gpu` marker); the check runs when the
    test runs, never at import or collection."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (none visible to JAX)")
    return gpus[0]

"""ray_tpu_torch ops against the JAX package on the CPU: rmsnorm,
layernorm, RoPE and mha_reference on the same numpy inputs; plus the
port's import hygiene (no jax, no ray_tpu, no top-level ml_dtypes, and no
string that names a ray_tpu module, as a worker's ``-m`` argument would).

Tolerances: f32 to 1e-6 (the same f32 formulas, summed in another order);
bf16 to one bf16 ulp of the reference value (both frameworks compute in
f32 and round once to bf16, so results differ by at most one rounding
step)."""

import ast
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rope as trope

from _torch_isolation import _module_isolation_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _j(a, dtype):
    return jnp.asarray(a, dtype)


def _t(a, dtype):
    return torch.tensor(a, dtype=torch.float32).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    # one bf16 ulp of the reference: 2^(exponent - 7)
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jnorms.rmsnorm(_j(x, jd), _j(w, jd), 1e-5)
    got = tnorms.rmsnorm(_t(x, td), _t(w, td), 1e-5)
    assert got.dtype == td
    _assert_close(got, want, dtype)


def test_rmsnorm_scales_by_one_plus_weight():
    x = torch.ones(1, 4)
    assert torch.allclose(tnorms.rmsnorm(x, torch.zeros(4)), x)
    assert torch.allclose(tnorms.rmsnorm(x, torch.ones(4)), 2 * x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layernorm_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    want = jnorms.layernorm(_j(x, jd), _j(w, jd), _j(b, jd))
    got = tnorms.layernorm(_t(x, td), _t(w, td), _t(b, td))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    D, S = 32, 64
    jc, js = jrope.rope_frequencies(D, S, 10000.0)
    tc, ts = trope.rope_frequencies(D, S, 10000.0)
    _assert_close(tc, jc, "f32")
    _assert_close(ts, js, "f32")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, D)).astype(np.float32)
    pos = rng.integers(0, S, (2, 6))
    # contiguous positions and explicit (decode-style) positions
    _assert_close(trope.apply_rope(_t(x, td), tc, ts),
                  jrope.apply_rope(_j(x, jd), jc, js), dtype)
    _assert_close(trope.apply_rope(_t(x, td), tc, ts, torch.as_tensor(pos)),
                  jrope.apply_rope(_j(x, jd), jc, js, jnp.asarray(pos)),
                  dtype)


@pytest.mark.parametrize("dtype,causal", [("f32", True), ("f32", False),
                                          ("bf16", True)])
def test_mha_reference_matches_jax(dtype, causal):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)   # GQA
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    want = jattn.mha_reference(_j(q, jd), _j(k, jd), _j(v, jd),
                               causal=causal)
    got = tattn.mha_reference(_t(q, td), _t(k, td), _t(v, td),
                              causal=causal)
    assert got.dtype == td and got.shape == (2, 10, 4, 16)
    _assert_close(got, want, dtype)


# ------------------------------------------------------------ import hygiene

def _port_files():
    scripts = os.path.join(REPO, "scripts")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
        if n.endswith(".py") and n.startswith(("torch_", "flash_"))]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    # the gloo ranks' side of the distributed tests runs the port alone
    files.append(os.path.join(REPO, "tests", "_torch_dist.py"))
    return files


_JAX_MODULE_NAME = re.compile(r"(?<![\w.])ray_tpu\.[A-Za-z_][\w.]*")


def _forbidden_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            if top in ("jax", "jaxlib", "ray_tpu"):
                bad.append(m)
    # a string naming a module of the JAX package (``"-m",
    # "ray_tpu.raylet.worker_factory"``) imports it in another process,
    # where no import statement shows it
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            bad += _JAX_MODULE_NAME.findall(node.value)
    # ml_dtypes may be imported only inside a function, never at the top
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            bad += [n for n in names if n.split(".")[0] == "ml_dtypes"]
    return bad


def test_port_imports_no_jax_and_nothing_of_ray_tpu():
    files = _port_files()
    assert len(files) >= 12, files
    offenders = {os.path.relpath(f, REPO): _forbidden_imports(f)
                 for f in files}
    offenders = {f: m for f, m in offenders.items() if m}
    assert not offenders, offenders


_LAZY_IMPORTS = ("pyarrow", "pandas", "PIL", "cloudpickle")


def _module_level_imports(path):
    """The modules a file imports at its top level (outside functions)."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_data_llm_tune_import_heavy_modules_inside_functions():
    """Data, batch LLM inference and Tune import pyarrow, pandas, PIL and
    cloudpickle only inside the functions that need them; the walk above
    covers these files (and the ``ray_tpu.`` names in their strings)."""
    files = [f for f in _port_files() if os.sep + os.path.join(
        "ray_tpu_torch", "") in f and os.path.relpath(
        f, os.path.join(REPO, "ray_tpu_torch")).split(os.sep)[0]
        in ("data", "llm", "tune")]
    assert len(files) == 15, files
    offenders = {os.path.relpath(f, REPO): [
        m for m in _module_level_imports(f)
        if m.split(".")[0] in _LAZY_IMPORTS] for f in files}
    assert not {f: m for f, m in offenders.items() if m}, offenders
    # and importing them loads none of those, nor torch
    import subprocess
    import sys

    code = ("import sys\n"
            "import ray_tpu_torch.data, ray_tpu_torch.llm, "
            "ray_tpu_torch.tune\n"
            "print([m for m in ('pyarrow', 'pandas', 'PIL', 'torch', 'jax') "
            "if m in sys.modules])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_package_lists_the_ported_libraries():
    import ray_tpu_torch
    from ray_tpu_torch.common.status import WAITING

    for name in ("data", "tune", "llm"):
        assert name in dir(ray_tpu_torch)
        assert name not in WAITING
        assert getattr(ray_tpu_torch, name).__name__ == f"ray_tpu_torch.{name}"


def test_hygiene_check_catches_offenders(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("import jax.numpy as jnp\nfrom ray_tpu.models import llama\n"
                 "import ml_dtypes\nimport ray_tpu_torch\n"
                 "def f():\n    import ml_dtypes\n")
    assert _forbidden_imports(str(p)) == ["jax.numpy", "ray_tpu.models",
                                          "ml_dtypes"]


def test_hygiene_check_catches_module_names_in_strings(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(
        "import subprocess, sys\n"
        "subprocess.Popen([sys.executable, '-m',\n"
        "                  'ray_tpu.raylet.worker_factory', 'sock'])\n"
        "ok = ['ray_tpu_torch.core_worker.worker_main',\n"
        "      'ray_tpu/ops/pallas/flash_attention.py:90']\n")
    assert _forbidden_imports(str(p)) == ["ray_tpu.raylet.worker_factory"]


def test_native_loaders_build_the_ports_own_sources():
    """Each C++ native the port loads is its own copy under
    ray_tpu_torch/, built into ray_tpu_torch/_build/ (never beside the
    JAX package's sources)."""
    from ray_tpu_torch.graph import channels
    from ray_tpu_torch.object_store import shm

    port = os.path.join(REPO, "ray_tpu_torch")
    assert os.path.commonpath([shm._SRC_DIR, port]) == port
    for src in ("shm_channel.cc", "shm_store.cc"):
        assert os.path.isfile(os.path.join(shm._SRC_DIR, src))
    for lib in (channels._load(), shm._load()):
        assert os.path.dirname(lib._name) == os.path.join(port, "_build")


def test_new_modules_import_without_jax_or_ray_tpu():
    """The modules of the graph, parallel, train, collective, RL, Data,
    batch LLM and Tune slices load in a fresh interpreter with no jax and
    nothing of ray_tpu in ``sys.modules``."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import ray_tpu_torch.graph, ray_tpu_torch.collective\n"
            "import ray_tpu_torch.cluster_utils, ray_tpu_torch.util\n"
            "import ray_tpu_torch.models.pipeline\n"
            "import ray_tpu_torch.parallel, ray_tpu_torch.train\n"
            "import ray_tpu_torch.ops.ring_attention\n"
            "import ray_tpu_torch.collective.xla_group\n"
            "import ray_tpu_torch.collective.quantization\n"
            "import ray_tpu_torch.train.pipeline, ray_tpu_torch.rl\n"
            "from ray_tpu_torch.rl import learner, learner_group, "
            "env_runner, module, envs, connectors, algorithm\n"
            "from ray_tpu_torch.util import ActorPool, Queue, state, "
            "profiling\n"
            "import ray_tpu_torch.data, ray_tpu_torch.llm, "
            "ray_tpu_torch.tune\n"
            "from ray_tpu_torch.data import (block, connectors, context, "
            "dataset, datasource, execution, optimizer, shuffle)\n"
            "from ray_tpu_torch.tune import search, search_algo, tuner\n"
            "from ray_tpu_torch.llm import batch\n"

            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""The port's import and device rules: repro_torch imports neither jax nor
anything of the JAX package, imports cleanly with jax unavailable, and its
entry points raise rather than fall back to the CPU when no card exists."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SCRIPT = ROOT / "chip_smoke.py"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [SCRIPT],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_unavailable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.launch.serve_cnn
        import repro_torch.launch.serve
        import repro_torch.launch.train
        import repro_torch.kernels.conv_pool.ops
        import repro_torch.kernels.flash_attention.ops
        import repro_torch.convert
        import repro_torch.obs
        import repro_torch.obs.tilesearch
        import repro_torch.serving.autotune
        import repro_torch.analysis.cli
        import repro_torch.core.pecr
        import repro_torch.models.cnn
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_history_and_scenarios_import_with_jax_unavailable():
    """The perf-history store and the scenario library import, and the
    history CLI answers, with jax and the JAX package unavailable."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        import repro_torch.obs.history
        import repro_torch.obs.history.cli
        import repro_torch.serving.scenarios
        from repro_torch.serving import HotSwapScenario, synth_image
        assert synth_image((2, 3, 3), 0, 0).shape == (2, 3, 3)
        assert repro_torch.obs.history.cli.main(["check", "--db", "missing.jsonl"]) == 2
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120, cwd=ROOT / "src")
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_run_context_names_no_jax():
    from repro_torch.obs.history import make_payload, run_context

    ctx = run_context()
    assert "jax" not in ctx["versions"] and "jaxlib" not in ctx["versions"]
    assert ctx["versions"]["torch"] == torch.__version__
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    assert ctx["device_kind"] == kind
    assert "jax" not in make_payload("x", [])["versions"]


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is a host check")
    from repro_torch.configs.lenet import LENET_REDUCED
    from repro_torch.convert import params_from_jax
    from repro_torch.graph import init_graph
    from repro_torch.launch.serve import serve
    from repro_torch.launch.serve_cnn import serve_cnn

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cnn(model="lenet", n_requests=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cnn(model="lenet", n_requests=2, calibrate=True, tile_search=True,
                  do_autotune=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("qwen3-0.6b", batch=1, prompt_len=2, gen_len=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_graph(torch.Generator().manual_seed(0), LENET_REDUCED)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"conv": [], "dense": []})


def test_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is a host check")
    from repro_torch.configs.base import DEFAULT_RUN, get_config
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.train import train

    cfg = get_config("qwen3-0.6b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("qwen3-0.6b", steps=1, ckpt_dir=tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, DEFAULT_RUN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, DEFAULT_RUN, torch.Generator().manual_seed(0))
    assert not any(tmp_path.iterdir())  # refused before anything was written


def test_kernel_wrapper_never_runs_the_plain_version_off_the_host():
    """A tensor that is neither on the host nor on CUDA raises; it is not
    quietly handed to the plain version."""
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch

    x = torch.zeros(1, 4, 4, 8, device="meta")
    w = torch.zeros(3, 3, 8, 4, device="meta")
    ids = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    cnt = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ecr_conv_batch(x, w, ids, cnt, stride=1, block_c=8)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_wrappers_never_run_the_plain_version_off_the_host(int8):
    from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_q8

    q = torch.zeros(2, 2, 3, 8, device="meta")
    kv = torch.zeros(2, 5, 8, device="meta", dtype=torch.int8 if int8 else torch.float32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        if int8:
            sc = torch.zeros(2, 5, device="meta")
            flash_fwd_q8(q, kv, kv, sc, sc, scale=1.0, causal=True)
        else:
            flash_fwd(q, kv, kv, scale=1.0, causal=True)


@pytest.mark.parametrize("which", ["flash_bwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_flash_backward_wrappers_never_run_the_plain_version_off_the_host(which):
    from repro_torch.kernels.flash_attention import kernel as K

    q = torch.zeros(2, 2, 3, 8, device="meta")
    kv = torch.zeros(2, 5, 8, device="meta")
    st = torch.zeros(2, 2, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        if which == "flash_bwd":
            K.flash_bwd(q, kv, kv, q, st, st, q, scale=1.0, causal=True)
        else:
            getattr(K, which)(q, kv, kv, q, st, st, st, scale=1.0, causal=True)


def test_kernel_build_stays_in_the_checkout(tmp_path, monkeypatch):
    """The library builds into the checkout's build/, or the named
    directory; an installed copy with no directory named raises."""
    from repro_torch.kernels import cuda

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert cuda.build_dir() == ROOT / "build" / "kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert cuda.library_path().parent == tmp_path
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    monkeypatch.setattr(cuda, "_CHECKOUT", tmp_path)
    with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
        cuda.build_dir()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """The card check runs first: without CUDA the script exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(SCRIPT)], capture_output=True,
                       text=True, env=env, timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_every_kernel_source_and_header_is_built_and_hashed():
    """The library's name hashes SOURCES and HEADERS alone, so a header left
    out would let a stale library load after an edit: every .cu under csrc/
    is in SOURCES, every .cuh in HEADERS, and every quoted #include of a
    source or header names a listed header."""
    import re

    from repro_torch.kernels import cuda

    csrc = PKG / "kernels" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(cuda.SOURCES)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(cuda.HEADERS)
    assert cuda.CSRC == csrc
    for path in sorted(csrc.glob("*.cu*")):
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            assert inc in cuda.HEADERS, f"{path.name} includes {inc}, not in HEADERS"

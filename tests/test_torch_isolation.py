"""hetu_tpu_torch stands alone: it imports neither jax nor hetu_tpu, its
entry points do not fall back to the CPU, and its kernel build does not
fall back to a plain version when nvcc is missing."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.kernels import _build
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hetu_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    # the JAX package, and the example zoos it imports by their bare names
    # (examples/ctr/models as ``models``)
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "hetu_tpu", "models", "examples")


def test_no_jax_or_hetu_tpu_import_in_the_port():
    sources = _port_sources()
    assert len(sources) > 15
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert bad == []


def test_a_cpu_step_loads_neither_jax_nor_hetu_tpu():
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import hetu_tpu_torch as ht
        x = ht.Variable(name="x", trainable=False)
        y_ = ht.Variable(name="y_", trainable=False)
        w = ht.init.random_normal((8, 4), stddev=0.1, name="w")
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(ht.matmul_op(x, w), y_), [0])
        train_op = ht.optim.AdamOptimizer(0.01).minimize(loss)
        ex = ht.Executor({"train": [loss, train_op]}, ctx=ht.cpu(0))
        feed = {x: np.ones((2, 8), np.float32),
                y_: np.eye(4, dtype=np.float32)[:2]}
        l0 = ex.run("train", feed_dict=feed)[0].asnumpy()
        l1 = ex.run("train", feed_dict=feed)[0].asnumpy()
        assert l1 < l0, (l0, l1)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_a_cpu_bert_forward_loads_neither_jax_nor_hetu_tpu():
    """The BERT forward (pretraining loss through both kernels' dispatch,
    and the classifier) on the CPU."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from hetu_tpu_torch.models import bert
        cfg = bert.BertConfig(vocab_size=50, d_model=32, n_heads=2,
                              n_layers=1, d_ff=64, max_seq_len=16,
                              dtype=torch.float32, attn_impl="flash",
                              fused_mlm_ce=True)
        params = bert.init_params(0, cfg, "cpu")
        rng = np.random.RandomState(0)
        rows = [(rng.randint(0, 50, 16), np.ones(16, np.int32),
                 np.zeros(16, np.int32), np.array([3, 5, 0]),
                 rng.randint(0, 50, 3), i % 2) for i in range(2)]
        batch = bert.batch_from_instances(rows, "cpu")
        with torch.inference_mode():
            loss, _ = bert.pretrain_loss(params, batch, cfg)
            cp = bert.init_classifier_params(1, cfg, 3, pretrained=params)
            logits = bert.classify_logits(cp, batch["input_ids"],
                                          batch["segment_ids"], cfg)
        assert torch.isfinite(loss) and logits.shape == (2, 3)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_a_cpu_bert_train_step_loads_neither_jax_nor_hetu_tpu():
    """Two BERT pretraining steps (flash and fused-CE backward through the
    dispatch, remat on, AdamW) on the CPU."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from hetu_tpu_torch.models import bert
        cfg = bert.BertConfig(vocab_size=50, d_model=32, n_heads=2,
                              n_layers=1, d_ff=64, max_seq_len=16,
                              dtype=torch.float32, attn_impl="flash",
                              fused_mlm_ce=True)
        params = bert.init_params(0, cfg, "cpu")
        opt = bert.init_opt_state(params)
        rng = np.random.RandomState(0)
        rows = [(rng.randint(0, 50, 16), np.ones(16, np.int32),
                 np.zeros(16, np.int32), np.array([3, 5, 0]),
                 rng.randint(0, 50, 3), i % 2) for i in range(2)]
        batch = bert.batch_from_instances(rows, "cpu")
        step = bert.make_pretrain_step(cfg, lr=1e-3)
        l0, _, params, opt = step(params, opt, batch)
        l1, _, params, opt = step(params, opt, batch)
        assert float(l1) < float(l0), (float(l0), float(l1))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_executor_without_cuda_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = ht.init.zeros((3,), name="w")
    with pytest.raises(RuntimeError, match=r"ctx=ht\.cpu\(0\)"):
        ht.Executor([ht.relu_op(w)])
    ht.Executor([ht.relu_op(w)], ctx=ht.cpu(0))     # the explicit CPU is fine


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("fused_opt")


def test_build_reports_nvcc_stderr(monkeypatch, tmp_path):
    """A failing nvcc raises with its stderr; nothing is left in place of
    the library."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.KernelBuildError, match="no sm_90a here"):
        _build.build_all()
    assert os.listdir(tmp_path / "build") == []    # no library, no temp file


def test_every_source_is_built_and_keyed_by_its_content():
    assert _build.sources() == ["csr_spmm", "embed_grad", "flash_attention",
                                "fused_ce", "fused_opt"]
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.startswith(_build.BUILD_DIR)
        assert path == _build.library_path(name)
    assert len({_build.library_path(n) for n in _build.sources()}) == 5
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

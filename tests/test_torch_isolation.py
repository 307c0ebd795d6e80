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


def test_a_cpu_tokenize_decode_and_dropout_step_load_neither():
    """The slice-5d path on the CPU: the WordPiece tokenizer, a greedy
    decode with the KV cache, a checkpoint round trip and one dropout
    train step load neither jax nor hetu_tpu."""
    script = textwrap.dedent("""
        import sys, tempfile
        import torch
        from hetu_tpu_torch import checkpoint
        from hetu_tpu_torch.tokenizers import BertTokenizer
        from hetu_tpu_torch.models import generate, transformer as tfm
        vocab = {t: i for i, t in enumerate(
            ["[PAD]", "[UNK]", "the", "fox", "dog", "runs", "##s"])}
        ids = BertTokenizer(vocab).encode("the fox runs the dogs")
        assert ids == [2, 3, 5, 2, 4, 6], ids
        cfg = tfm.TransformerConfig(vocab_size=7, d_model=16, n_heads=2,
                                    n_layers=1, d_ff=32, max_seq_len=12,
                                    dtype=torch.float32, dropout_rate=0.1)
        params = tfm.init_params(0, cfg, "cpu")
        toks = generate.generate(params, cfg, [ids], max_len=10)
        assert toks.shape == (1, 10) and list(toks[0, :6]) == ids
        tokens = torch.tensor([ids + ids])
        opt = tfm.init_opt_state(params)
        loss, params, opt = tfm.make_train_step(cfg)(
            params, opt, tokens, tokens.roll(-1, 1), 7)
        assert torch.isfinite(loss)
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save(d + "/ck", {"params": params, "opt": opt})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_a_cpu_dp_step_loads_neither_jax_nor_hetu_tpu(tmp_path):
    """The data-parallel path on the CPU: the runner, the process group
    (one gloo rank), an explicit dp mesh and the quantized all-reduce
    (comm_quant, the quant_comm kernels' plain versions)."""
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import hetu_tpu_torch as ht
        from hetu_tpu_torch import comm_quant, runner
        from hetu_tpu_torch.parallel import multihost
        multihost.initialize("file://{tmp_path}/store", 1, 0, device="cpu")
        x = ht.Variable(name="x", trainable=False)
        y_ = ht.Variable(name="y_", trainable=False)
        w = ht.init.random_normal((64, 4), stddev=0.1, name="w")
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(ht.matmul_op(x, w), y_), [0])
        train_op = ht.optim.SGDOptimizer(0.1).minimize(loss)
        ex = ht.Executor({{"train": [loss, train_op]}}, ctx=ht.cpu(0),
                         comm_mode="AllReduce", mesh=multihost.global_mesh(),
                         comm_quant="fp8", comm_quant_min_size=256)
        assert len(ex.qar_ops) == 1 and ex.state["qresid"]
        feed = {{x: np.ones((8, 64), np.float32),
                 y_: np.eye(4, dtype=np.float32)[np.arange(8) % 4]}}
        l0 = ex.run("train", feed_dict=feed)[0].asnumpy()
        l1 = ex.run("train", feed_dict=feed)[0].asnumpy()
        assert l1 < l0, (l0, l1)
        multihost.shutdown()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_a_cpu_pipeline_step_loads_neither_jax_nor_hetu_tpu(tmp_path):
    """The slice-8a path on the CPU: two gloo ranks (a file store) lay a
    pp = 2 mesh and take a GPipe, a 1F1B and a ZeRO-1 step of the
    transformer pipeline, and a two-stage graph-API GPipe step."""
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        import hetu_tpu_torch as ht
        from hetu_tpu_torch.models import transformer as tfm
        from hetu_tpu_torch.parallel import mesh as meshlib, multihost
        from hetu_tpu_torch.parallel import pipeline as pl
        rank = int(sys.argv[1])
        multihost.initialize("file://{tmp_path}/store", 2, rank,
                             device="cpu")
        mesh = meshlib.make_mesh(pp=2)
        cfg = tfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                    n_layers=2, d_ff=32, max_seq_len=8,
                                    dtype=torch.float32, remat=False)
        tok = torch.randint(0, 32, (2, 2, 8), generator=torch.Generator()
                            .manual_seed(0))
        for make in (pl.make_pipeline_train_step,
                     pl.make_pipeline_train_step_1f1b):
            for zero1 in (False, True):
                p = pl.init_pipeline_params(0, cfg, mesh, "cpu")
                o = pl.shard_pipeline_opt_state(tfm.init_opt_state(p), cfg,
                                                mesh, zero1)
                loss, p, o = make(cfg, mesh, 2, zero1=zero1)(
                    p, o, tok, tok.roll(-1, 2))
                assert torch.isfinite(loss)
        with ht.context(ht.cpu(0)):
            x = ht.Variable(name="x", trainable=False)
            h = ht.relu_op(ht.matmul_op(x, ht.init.random_normal(
                (4, 8), stddev=0.1, name="w0")))
        with ht.context(ht.cpu(1)):
            y_ = ht.Variable(name="y_", trainable=False)
            loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
                ht.matmul_op(h, ht.init.random_normal((8, 3), stddev=0.1,
                                                      name="w1")), y_), [0])
            op = ht.optim.SGDOptimizer(0.1).minimize(loss)
        ex = ht.Executor({{"train": [loss, op]}}, gpipe=True, seed=0,
                         ctx=ht.cpu(0))
        fd = [{{x: np.ones((2, 4), np.float32),
                y_: np.eye(3, dtype=np.float32)[:2]}}] * 2
        assert np.isfinite(ex.run("train", feed_dict=fd,
                                  convert_to_numpy_ret_vals=True)[0]).all()
        multihost.shutdown()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert "LOADED []" in out, out


def test_a_cpu_tp_sp_ep_step_loads_neither_jax_nor_hetu_tpu(tmp_path):
    """The slice-8b path on the CPU: two gloo ranks (a file store) run each
    of multihost's group collectives and ring attention
    (parallel/ring_attention.py, under kernels "off" and "auto"), then a
    trunk step at tp 2, at sp 2 and a MoE step at ep 2, a BERT step at sp
    2 and a greedy decode at tp 2."""
    source = os.path.join(PKG, "parallel", "ring_attention.py")
    assert source in _port_sources()
    script = textwrap.dedent(f"""
        import sys
        import torch
        from hetu_tpu_torch.kernels import registry
        from hetu_tpu_torch.models import bert, generate, transformer as tfm
        from hetu_tpu_torch.parallel import mesh as meshlib, multihost
        from hetu_tpu_torch.parallel import ring_attention as ra
        rank = int(sys.argv[1])
        multihost.initialize("file://{tmp_path}/store", 2, rank,
                             device="cpu")
        g = multihost.group([0, 1])
        x = torch.full((2, 3), rank + 1.0, requires_grad=True)
        y = (multihost.copy_to(x, g) + multihost.reduce_from(x, g)
             + multihost.sum_both(x, g)).sum()
        y = y + multihost.gather_dim(x, 0, g).sum() + multihost.gather_dim(
            x, 1, g, grad="slice").sum()
        y.backward()
        assert torch.isfinite(x.grad).all()
        assert multihost.ring_exchange([x.detach()], g)[0][0, 0] == 2 - rank
        q = torch.randn((1, 2, 4, 8), generator=torch.Generator()
                        .manual_seed(rank)).requires_grad_()
        for mode in ("off", "auto"):
            with registry.active(mode):
                ra.ring_attention(q, q, q, group=g, causal=True).sum().backward()
        cfg = tfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                    n_layers=1, d_ff=32, max_seq_len=8,
                                    dtype=torch.float32, remat=False)
        tok = torch.randint(0, 32, (2, 8), generator=torch.Generator()
                            .manual_seed(0))
        moe = tfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                    n_layers=1, d_ff=32, max_seq_len=8,
                                    n_experts=2, dtype=torch.float32,
                                    remat=False)
        for c, kw in ((cfg, dict(tp=2)), (cfg, dict(sp=2)),
                      (moe, dict(ep=2))):
            mesh = meshlib.make_mesh(**kw)
            p = tfm.shard_params(tfm.init_params(0, c, "cpu"), c, mesh)
            loss, p, o = tfm.make_train_step(c, mesh)(
                p, tfm.init_opt_state(p), tok, tok.roll(-1, 1))
            assert torch.isfinite(loss)
        mesh = meshlib.make_mesh(sp=2)
        bcfg = bert.BertConfig(vocab_size=32, d_model=16, n_heads=2,
                               n_layers=1, d_ff=32, max_seq_len=8,
                               dtype=torch.float32)
        p = bert.init_params(0, bcfg, "cpu")
        batch = dict(input_ids=tok, segment_ids=tok * 0,
                     input_mask=torch.ones_like(tok),
                     mlm_positions=torch.tensor([[1, 2], [3, 4]]),
                     mlm_ids=tok[:, :2], mlm_weights=torch.ones((2, 2)),
                     nsp_label=torch.tensor([0, 1]))
        loss = bert.make_pretrain_step(bcfg, mesh)(
            p, bert.init_opt_state(p), batch)[0]
        assert torch.isfinite(loss)
        mesh = meshlib.make_mesh(tp=2)
        p = tfm.shard_params(tfm.init_params(0, cfg, "cpu"), cfg, mesh)
        toks, _ = generate.make_generate_fn(cfg, 6, mesh=mesh)(p, tok[:, :3])
        assert toks.shape == (2, 6)
        multihost.shutdown()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert "LOADED []" in out, out


def test_a_cpu_hybrid_step_loads_neither_jax_nor_hetu_tpu():
    """Two Hybrid steps of a small WDL-Criteo against a local PS cluster
    (the port's own library, its light roles) on the CPU."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import hetu_tpu_torch as ht
        from hetu_tpu_torch.examples import ctr_models
        from hetu_tpu_torch.ps.local_cluster import local_cluster
        data = ctr_models.load_criteo_data(feature_dimension=100,
                                           n_train=32, n_test=16)[0]
        with local_cluster(n_servers=1):
            loaders = [ht.dataloader_op([ht.Dataloader(x, 16, "train")])
                       for x in data]
            loss, _, _, op = ctr_models.wdl_criteo(
                *loaders, feature_dimension=100, embedding_size=4)
            ex = ht.Executor({"train": [loss, op]}, ctx=ht.cpu(0),
                             comm_mode="Hybrid", cstable_policy="LFUOpt")
            losses = [ex.run("train")[0].asnumpy() for _ in range(2)]
            assert np.isfinite(losses).all()
            ex.close()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=180, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_the_light_launcher_imports_no_package():
    """``ps/_light_role.py`` runs a scheduler or a server with ctypes alone:
    its imports are the standard library's, and importing it loads
    neither torch nor jax."""
    path = os.path.join(PKG, "ps", "_light_role.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"ctypes", "os", "sys", "time"}
    probe = (f"import runpy, sys; runpy.run_path({path!r}, run_name='probe')"
             "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'numpy', 'hetu_tpu', 'hetu_tpu_torch')))")
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]", p.stdout


def test_ps_build_without_gxx_raises(monkeypatch, tmp_path):
    from hetu_tpu_torch.ps import _build as ps_build
    monkeypatch.setattr(ps_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(ps_build.PSBuildError, match="g\\+\\+ not found"):
        ps_build.build()


def test_ps_build_reports_the_compilers_stderr(monkeypatch, tmp_path):
    """A failing g++ raises with its stderr; no library and no temporary
    file is left, only the lock."""
    from hetu_tpu_torch.ps import _build as ps_build
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'error: no capi.cc here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(ps_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(ps_build.PSBuildError, match="no capi.cc here"):
        ps_build.build()
    assert os.listdir(tmp_path / "build") == ["libhetu_ps.lock"]
    path = ps_build.library_path()
    assert path.startswith(str(tmp_path / "build")) and path.endswith(".so")
    assert path == ps_build.library_path()      # keyed by content, stable


def test_nccl_without_cuda_raises_instead_of_using_gloo(monkeypatch,
                                                         tmp_path):
    from hetu_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize(f"file://{tmp_path}/store", 1, 0,
                             device="cuda:0")
    assert not multihost.is_initialized()


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
                                "fused_ce", "fused_opt", "quant_comm"]
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.startswith(_build.BUILD_DIR)
        assert path == _build.library_path(name)
    assert len({_build.library_path(n) for n in _build.sources()}) == 6
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_resources_reads_ptxas_and_sass():
    """``_build.read_resources`` on the report shapes ptxas -v and
    cuobjdump -sass print: registers, spills, static shared memory and the
    tensor-core and cp.async instructions, per kernel."""
    ptxas = (
        "ptxas info    : Compiling entry function 'k_tc' for 'sm_90a'\n"
        "ptxas info    : Function properties for k_tc\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 99 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function 'k_f32' for 'sm_90a'\n"
        "ptxas info    : Function properties for k_f32\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 48 registers, used 1 barriers, 16896 bytes "
        "smem, 416 bytes cmem[0]\n")
    sass = (
        "\t\tFunction : k_tc\n"
        "        /*07c0*/   LDGSTS.E.BYPASS.128 [R4], desc[UR10][R6.64] ;\n"
        "        /*75c0*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR20], R24 ;\n"
        "        /*7710*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR20], R24 ;\n"
        "\t\tFunction : k_f32\n"
        "        /*4f90*/   HMMA.16816.F32.BF16 R12, R16.reuse, R8, RZ ;\n"
        "        /*4fa0*/   FFMA R1, R2, R3, R1 ;\n")
    got = {k["kernel"]: k for k in _build.read_resources(ptxas, sass)}
    assert got["k_tc"] == {"kernel": "k_tc", "spill_stores": 8,
                           "spill_loads": 4, "registers": 99, "HGMMA": 2,
                           "HMMA": 0, "LDGSTS": 1}
    assert got["k_f32"] == {"kernel": "k_f32", "spill_stores": 0,
                            "spill_loads": 0, "registers": 48,
                            "static_smem": 16896, "HGMMA": 0, "HMMA": 1,
                            "LDGSTS": 0}

"""The port's checkpoint manager over its trees (dicts, lists, tensors;
``opt_state`` with its int32 step), mirroring ``tests/test_checkpoint.py``:
a bitwise round trip, bf16 leaves, a torn write ignored, gc keeping the
newest, and a run stopped and resumed bitwise an uninterrupted one -- with
the port's train step and again through the launchers, which then serve
the checkpoint (``repro_torch.launch.serve --ckpt-dir``).  Plain PyTorch
on the CPU; nothing here imports JAX."""
import os
import shutil

import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree as T
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import LoopConfig, make_train_step, train_loop

torch.set_num_threads(1)  # test workers share the cores: one thread each

CFG = get_smoke_config("smollm-360m")


def _tree_equal(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _fresh(opt):
    params = M.init_model(CFG, torch.Generator().manual_seed(0),
                          device="cpu")
    return params, O.init_opt_state(params, opt)


def test_roundtrip_bitwise(tmp_path):
    params, opt_state = _fresh(O.OptimizerConfig())
    opt_state["step"] += 7
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, params, opt_state)
    restored, step = mgr.restore({"params": params, "opt_state": opt_state})
    assert step == 10
    assert _tree_equal(restored["params"], params)
    assert _tree_equal(restored["opt_state"], opt_state)
    assert restored["opt_state"]["step"].dtype == torch.int32
    assert isinstance(restored["params"]["groups"][1], list)
    for leaf in T.leaves(restored):
        assert leaf.is_contiguous() and not leaf.requires_grad


def test_bf16_leaves_roundtrip(tmp_path):
    tree = {"w": torch.arange(16, dtype=torch.bfloat16) * 0.1,
            "b": [torch.tensor([1e-40, -3.5], dtype=torch.bfloat16)]}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    restored, _ = mgr.restore({"params": tree, "opt_state": None})
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert _tree_equal(restored["params"], tree)


def test_torn_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones(4)}
    mgr.save(1, tree)
    # a crash mid-save of step 2: the tmp dir exists, never renamed ...
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "junk").write_text("partial")
    # ... and a LATEST naming a checkpoint that never completed
    (tmp_path / "LATEST").write_text("2")
    mgr2 = CheckpointManager(str(tmp_path))
    assert not (tmp_path / "step_00000002.tmp").exists()
    assert mgr2.latest_step() == 1     # falls back to the newest valid
    restored, step = mgr2.restore({"params": tree, "opt_state": None})
    assert step == 1 and torch.equal(restored["params"]["w"], tree["w"])


def test_gc_keeps_recent(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    names = sorted(p for p in os.listdir(tmp_path) if p.startswith("step_"))
    assert names == ["step_00000003", "step_00000004"]
    assert (tmp_path / "LATEST").read_text() == "4"


def test_restore_params_alone_onto_a_meta_template(tmp_path):
    """A trainer's checkpoint (params + AdamW state) restores its
    parameters alone into a shapes-only template, on the device asked
    for; a template of another structure is refused."""
    params, opt_state = _fresh(O.OptimizerConfig())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params, opt_state)
    like = M.init_model(CFG, torch.Generator().manual_seed(1), device="meta")
    restored, step = mgr.restore({"params": like, "opt_state": None},
                                 device="cpu")
    assert step == 3 and restored["opt_state"] is None
    assert _tree_equal(restored["params"], params)
    other = M.init_model(CFG.with_(n_layers=3), torch.Generator(),
                         device="meta")
    with pytest.raises(ValueError, match="structure changed"):
        mgr.restore({"params": other, "opt_state": None}, device="cpu")
    wide = M.init_model(CFG.with_(d_ff=CFG.d_ff * 2), torch.Generator(),
                        device="meta")
    with pytest.raises(ValueError, match="template"):
        mgr.restore({"params": wide, "opt_state": None}, device="cpu")


def test_restart_resumes_identically(tmp_path):
    """Kill-and-restart gives bitwise the parameters of an uninterrupted
    run: the checkpoint plus the step-indexed data (the port's step)."""
    opt = O.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    batch_fn = make_batch_fn(CFG, seq_len=32, global_batch=4)
    step_fn = make_train_step(CFG, opt)

    p_a, s_a = _fresh(opt)
    for i in range(6):
        p_a, s_a, _ = step_fn(p_a, s_a, batch_fn(i))

    p_b, s_b = _fresh(opt)
    mgr = CheckpointManager(str(tmp_path))
    p_b, s_b, _ = train_loop(step_fn, p_b, s_b, batch_fn,
                             LoopConfig(total_steps=3, checkpoint_every=3),
                             checkpoint_mgr=mgr, log=lambda _: None)
    del p_b, s_b
    p0, s0 = _fresh(opt)
    restored, start = mgr.restore({"params": p0, "opt_state": s0})
    assert start == 3 and int(restored["opt_state"]["step"]) == 3
    p_c, s_c, _ = train_loop(step_fn, restored["params"],
                             restored["opt_state"], batch_fn,
                             LoopConfig(total_steps=6, checkpoint_every=50),
                             start_step=start, log=lambda _: None)
    assert _tree_equal(p_a, p_c)
    assert _tree_equal(s_a, s_c)


def test_launchers_train_resume_and_serve(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` in-process on the CPU: a
    4-step run checkpointing every 2 steps; the same run stopped while it
    wrote its step-4 checkpoint (that checkpoint torn, ``LATEST`` naming
    it) auto-resumes from step 2 to bitwise the uninterrupted parameters
    and moments; then the serve launcher serves that checkpoint."""
    argv = ["--arch", "smollm-360m", "--smoke-size", "--device", "cpu",
            "--steps", "4", "--seq-len", "32", "--global-batch", "2",
            "--ckpt-every", "2"]
    full, cut = tmp_path / "full", tmp_path / "cut"
    assert train_launcher.main(argv + ["--ckpt-dir", str(full)]) == 0
    out = capsys.readouterr().out
    assert "losses " in out and "done: loss" in out
    shutil.copytree(full, cut)
    (cut / "step_00000004" / "manifest.json").unlink()
    assert train_launcher.main(argv + ["--ckpt-dir", str(cut)]) == 0
    assert "auto-resumed from step 2" in capsys.readouterr().out
    like = {"params": M.init_model(CFG, torch.Generator(), device="meta")}
    like["opt_state"] = O.init_opt_state(like["params"], O.OptimizerConfig())
    a, sa = CheckpointManager(str(full)).restore(like, device="cpu")
    b, sb = CheckpointManager(str(cut)).restore(like, device="cpu")
    assert sa == sb == 4
    assert _tree_equal(a, b)
    assert serve_launcher.main(["--arch", "smollm-360m", "--smoke-size",
                                "--device", "cpu", "--paged", "--requests",
                                "2", "--max-new", "3", "--ckpt-dir",
                                str(cut)]) == 0
    assert "loaded checkpoint step 4" in capsys.readouterr().out

"""Checkpoints (``repro_torch.ckpt``) against the reference's
``repro.ckpt``, ``train_svm --ckpt-dir`` against the reference's CLI, and
the end-to-end example that saves every level."""
import importlib.util
import json
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.ckpt import CheckpointManager as JManager
from repro.launch import train_svm as jtrain
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import train_svm

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
DTYPES = [torch.float32, torch.float64, torch.int32, torch.bool,
          torch.bfloat16]


def _tree(dtype):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return (torch.randn(shape, generator=g) * 4).to(dtype)

    return {"alpha": t(5), "nested": {"a": [t(2, 3), (t(1), t(4))],
                                      "b": t()}, "none": None}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_round_trip(tmp_path, dtype):
    """Nested dicts, lists and tuples; the keys are the reference's keystr
    paths; bf16 is stored (and restores) as f32, or as bf16 into a bf16
    target, the same values."""
    tree = _tree(dtype)
    save_pytree(str(tmp_path / "t.npz"), tree)
    with np.load(tmp_path / "t.npz") as z:
        assert sorted(z.files) == ["['alpha']", "['nested']['a'][0]",
                                   "['nested']['a'][1][0]",
                                   "['nested']['a'][1][1]",
                                   "['nested']['b']"]
        stored = z["['alpha']"].dtype
    assert stored == (np.float32 if dtype == torch.bfloat16
                      else torch.empty(0, dtype=dtype).numpy().dtype)
    back = load_pytree(str(tmp_path / "t.npz"), tree)
    assert back["none"] is None and isinstance(back["nested"]["a"][1], tuple)
    for a, b in zip(ckpt._paths(tree), ckpt._paths(back)):
        assert a[0] == b[0] and b[1].dtype == dtype and torch.equal(a[1], b[1])
    f32 = load_pytree(str(tmp_path / "t.npz"),
                      {"alpha": torch.empty(0, device="meta")})
    assert f32["alpha"].dtype == torch.float32
    assert torch.equal(f32["alpha"], tree["alpha"].float())


def test_rotation_manifest_and_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None and mgr.steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore({"alpha": torch.zeros(3)})
    a = torch.arange(3.0)
    for step in (1, 2, 3):
        mgr.save(step, {"alpha": a * step})
    # the host copy was taken in save: a later in-place write cannot reach
    # the file the thread writes
    a.fill_(-1.0)
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "manifest.json", "step_0000000002.npz", "step_0000000003.npz"]
    assert json.loads((tmp_path / "manifest.json").read_text())["steps"] \
        == [2, 3]
    for step in (2, 3):
        got = mgr.restore({"alpha": torch.zeros(3)}, step=step,
                          device="cpu")
        assert torch.equal(got["alpha"], torch.arange(3.0) * step)
    mgr.save(4, {"alpha": a}, blocking=True)
    assert mgr._thread is None and mgr.latest_step() == 4
    sync = CheckpointManager(str(tmp_path / "sync"), async_save=False)
    sync.save(7, {"x": torch.ones(2)})
    assert sync._thread is None and sync.steps() == [7]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_files_cross_between_the_packages(tmp_path, writer):
    """A step written by either package's manager restores in the other's,
    leaf for leaf (bf16 stored as f32 by both)."""
    rng = np.random.default_rng(0)
    arrays = {"alpha": rng.standard_normal(6).astype(np.float32),
              "level": np.int32(2),
              # f32 values in f64: the reference (x64 off) stores f32
              "blocks": [rng.standard_normal((2, 2)).astype(np.float32)
                         .astype(np.float64),
                         rng.standard_normal(3).astype(np.float32)]}
    bf = rng.standard_normal(4).astype(ml_dtypes.bfloat16)
    jtree = {**{k: jnp.asarray(v) if not isinstance(v, list)
                else [jnp.asarray(b) for b in v] for k, v in arrays.items()},
             "bf": jnp.asarray(bf)}
    ttree = {"alpha": torch.from_numpy(arrays["alpha"]),
             "level": torch.tensor(2, dtype=torch.int32),
             "blocks": [torch.from_numpy(b) for b in arrays["blocks"]],
             "bf": torch.from_numpy(bf.astype(np.float32)).bfloat16()}
    d = str(tmp_path)
    if writer == "reference":
        JManager(d).save(5, jtree, blocking=True)
        got = CheckpointManager(d).restore(ttree)
        for (k, want), (_, leaf) in zip(ckpt._paths(ttree),
                                        ckpt._paths(got)):
            assert leaf.dtype == want.dtype and torch.equal(leaf, want), k
    else:
        CheckpointManager(d).save(5, ttree, blocking=True)
        with np.load(f"{d}/step_0000000005.npz") as z:
            assert z["['bf']"].dtype == np.float32
        got = JManager(d).restore(jtree)
        assert JManager(d).latest_step() == 5
        for (k, want), (_, leaf) in zip(ckpt._paths(jtree),
                                        ckpt._paths(got)):
            assert leaf.dtype == want.dtype, k
            np.testing.assert_array_equal(np.asarray(leaf, np.float64),
                                          np.asarray(want, np.float64))


def _steps(d):
    mgr = CheckpointManager(d)
    out = {}
    for s in mgr.steps():
        tree = mgr.restore({"alpha": torch.zeros(0),
                            "level": torch.zeros((), dtype=torch.int32)},
                           step=s)
        out[s] = tree
    return out


def test_train_cli_ckpt_dir_writes_the_reference_steps(tmp_path, capsys):
    """``--ckpt-dir``: the steps and levels the reference's CLI writes for
    the same arguments (levels 2: steps 1-3 for levels 2, 1, 0), each alpha
    one entry a training row, in [0, C]."""
    args = ["--n", "600", "--levels", "2", "--ckpt-dir"]
    train_svm.main(args + [str(tmp_path / "port"), "--device", "cpu"])
    jtrain.main(args + [str(tmp_path / "reference")])
    out = capsys.readouterr().out
    assert out.count("done in") == 2
    got, want = (_steps(str(tmp_path / w)) for w in ("port", "reference"))
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for s in got:
        assert got[s]["level"].shape == () and got[s]["level"].dtype == torch.int32
        assert int(got[s]["level"]) == int(want[s]["level"]) == 3 - s
        a = got[s]["alpha"]
        assert a.shape == want[s]["alpha"].shape == (480,)
        assert bool(torch.isfinite(a).all()) and 0 <= float(a.min()) \
            and float(a.max()) <= 4.0


def test_end_to_end_example_saves_every_level(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "end_to_end_dcsvm_torch", EXAMPLES / "end_to_end_dcsvm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--n", "600", "--levels", "2",
              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "exact test acc" in out and "DC-SVM (early)" in out
    acc = float(out.split("exact test acc ")[1].split()[0])
    assert acc > 0.8
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [2, 3]            # keep=2 of levels 2, 1, 0
    alpha = mgr.restore({"alpha": torch.zeros(0)})["alpha"]
    assert alpha.shape == (480,) and bool(torch.isfinite(alpha).all())

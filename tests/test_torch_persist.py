"""The port's persistence against the JAX package's: word2vec text byte
for byte, checkpoints that round-trip, resume bit-exactly on the CPU and
cross-load with ``come_tpu.iohelpers`` both ways, ``train(checkpoint_dir=)``
and the CLI's ``--save``, ``--checkpoint-dir`` and ``--resume``.
"""

import jax
import numpy as np
import pytest
import torch

from come_tpu.config import get_config as j_get_config
from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu.iohelpers import load_checkpoint as j_load_checkpoint
from come_tpu.iohelpers import load_embedding_word2vec as j_load_w2v
from come_tpu.iohelpers import save_embedding_word2vec as j_save_w2v
from come_tpu.trainer import ComETrainer as JTrainer
from come_tpu_torch.config import get_config
from come_tpu_torch.graphs import get_dataset
from come_tpu_torch.iohelpers import (
    load_embedding_word2vec,
    save_embedding_word2vec,
)
from come_tpu_torch.iohelpers.persist import threefry_key_data
from come_tpu_torch.main import main
from come_tpu_torch.models.state import FIELDS
from come_tpu_torch.trainer import ComETrainer

torch.set_num_threads(2)


def _emb(v=7, d=5, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(v, d)).astype(np.float32) * np.float32(3.0)
    e[0, 0], e[1, 1], e[2, 2] = -0.0, 1e-9, -123.4567891
    return e


@pytest.mark.parametrize("names", [None, ["a", "b", "c", 4, "e", "f", "g"]])
def test_word2vec_text_is_the_jax_writers(tmp_path, names):
    emb = _emb()
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    save_embedding_word2vec(ours, emb, names)
    j_save_w2v(theirs, emb, names)
    assert ours.read_bytes() == theirs.read_bytes()
    back, got_names = load_embedding_word2vec(ours)
    j_back, j_names = j_load_w2v(theirs)
    np.testing.assert_array_equal(back, j_back)
    assert got_names == j_names == [
        str(n) for n in (names or range(7))]
    # the text holds each value to its sixth decimal, correctly rounded
    text = _text_values(ours)
    assert np.abs(text - emb.astype(np.float64)).max() <= 5e-7 + TEXT_SLACK
    np.testing.assert_array_equal(back, text.astype(np.float32))


# the float64 parse of a six-place decimal below 2^7 is off by < 1e-14
TEXT_SLACK = 1e-12


def _text_values(path) -> np.ndarray:
    """The numbers of a word2vec text file as written, in float64."""
    return np.array([line.split()[1:] for line in
                     open(path).read().splitlines()[1:]], np.float64)


def _karate_trainer(**kw):
    cfg = get_config("karate").replace(**{"outer_iters": 2,
                                          "pretrain_epochs": 1, **kw})
    return ComETrainer(get_dataset("karate").graph, cfg, "cpu")


def _params(t):
    return {k: getattr(t.params, k).numpy().copy() for k in FIELDS}


def test_checkpoint_roundtrip(tmp_path):
    t = _karate_trainer()
    t.o1_epoch()
    t.fit_gmm()
    ckpt = tmp_path / "state.npz"
    t.save_checkpoint(ckpt)
    t2 = _karate_trainer(seed=11)  # other init, other streams
    restored = t2.load_checkpoint(ckpt)
    assert restored == {"gen": True, "host_gen": True}
    for k, v in _params(t).items():
        np.testing.assert_array_equal(getattr(t2.params, k).numpy(), v)
    assert t2.words_seen == t.words_seen > 0
    assert torch.equal(t2.gen.get_state(), t.gen.get_state())
    assert torch.equal(t2.host_gen.get_state(), t.host_gen.get_state())
    assert sorted(f.name for f in tmp_path.iterdir()) == ["state.npz"]


def test_resume_is_bit_exact_on_the_cpu(tmp_path):
    """A trainer loaded from a checkpoint continues the uninterrupted run
    bit for bit: an O1 epoch, then a whole outer iteration (GMM on the host
    generator, O1, O2, O3)."""
    t = _karate_trainer()
    t.o1_epoch()
    ckpt = tmp_path / "state.npz"
    t.save_checkpoint(ckpt)
    t2 = _karate_trainer(seed=5)
    t2.load_checkpoint(ckpt)
    assert t.o1_epoch() == t2.o1_epoch()
    r1, r2 = t.outer_iteration(0), t2.outer_iteration(0)
    for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss", "o1_pairs"):
        assert r1[k] == r2[k], k
    for k, v in _params(t).items():
        np.testing.assert_array_equal(getattr(t2.params, k).numpy(), v)
    assert t.words_seen == t2.words_seen


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jt = JTrainer(j_get_dataset("karate").graph, j_get_config("karate"))
    jt.o1_epoch()
    jt.fit_gmm()
    ckpt = tmp_path / "jax.npz"
    jt.save_checkpoint(ckpt)
    t = _karate_trainer()
    gen0, host0 = t.gen.get_state(), t.host_gen.get_state()
    assert t.load_checkpoint(ckpt) == {"gen": False, "host_gen": False}
    for k in FIELDS:
        np.testing.assert_array_equal(
            getattr(t.params, k).numpy(),
            np.asarray(getattr(jt.state.params, k)))
    assert t.words_seen == float(jt.state.words_seen) > 0
    # the JAX streams cannot be taken over: the port's stay as they were
    assert torch.equal(t.gen.get_state(), gen0)
    assert torch.equal(t.host_gen.get_state(), host0)
    t.o1_epoch()  # and it trains on


def test_port_checkpoint_loads_into_jax(tmp_path):
    t = _karate_trainer(seed=3)
    t.o1_epoch()
    t.fit_gmm()
    ckpt = tmp_path / "port.npz"
    t.save_checkpoint(ckpt)
    state = j_load_checkpoint(ckpt)
    for k, v in _params(t).items():
        np.testing.assert_array_equal(np.asarray(getattr(state.params, k)), v)
    assert float(state.words_seen) == float(np.float32(t.words_seen))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(state.key)),
        np.asarray(jax.random.key_data(jax.random.key(3))))
    jt = JTrainer(j_get_dataset("karate").graph, j_get_config("karate"))
    jt.load_checkpoint(ckpt)  # no host_key: JAX keeps its own
    jt.o1_epoch()


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5, -1])
def test_threefry_key_data(seed):
    np.testing.assert_array_equal(
        threefry_key_data(seed),
        np.asarray(jax.random.key_data(jax.random.key(seed))))


def test_load_refuses_another_shape_before_touching_the_streams(tmp_path):
    t = _karate_trainer()
    ckpt = tmp_path / "state.npz"
    t.save_checkpoint(ckpt)
    t2 = _karate_trainer(dim=8, seed=4)
    gen0 = t2.gen.get_state()
    with pytest.raises(ValueError, match="expected"):
        t2.load_checkpoint(ckpt)
    assert torch.equal(t2.gen.get_state(), gen0)


def test_train_writes_one_checkpoint_per_iteration(tmp_path):
    t = _karate_trainer(outer_iters=3)
    hist = t.train(checkpoint_dir=tmp_path / "ck")
    assert len(hist) == 3
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == [f"state_iter{i}.npz" for i in range(3)]
    with np.load(tmp_path / "ck" / "state_iter2.npz") as z:
        np.testing.assert_array_equal(z["node_emb"],
                                      t.params.node_emb.numpy())
        assert float(z["words_seen"]) == t.words_seen


def test_main_save_checkpoint_dir_and_resume(tmp_path):
    ck, emb = tmp_path / "ck", tmp_path / "emb.txt"
    base = ["--device", "cpu", "--outer-iters", "2", "--pretrain-epochs",
            "1"]
    assert main([*base, "--checkpoint-dir", str(ck)]) == 0
    assert main([*base, "--outer-iters", "1", "--save", str(emb),
                 "--resume", str(ck / "state_iter1.npz"),
                 "--checkpoint-dir", str(tmp_path / "ck2")]) == 0
    back, names = load_embedding_word2vec(emb)
    assert back.shape == (34, 16) and len(names) == 34
    with np.load(tmp_path / "ck2" / "state_iter0.npz") as z:
        text = _text_values(emb)
        err = np.abs(text - z["node_emb"].astype(np.float64)).max()
        assert err <= 5e-7 + TEXT_SLACK
        with np.load(ck / "state_iter1.npz") as z1:
            # the resumed run went on from the saved words_seen
            assert float(z["words_seen"]) > float(z1["words_seen"])

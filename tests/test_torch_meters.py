"""The port's small evaluation utilities against the JAX package's on the
CPU: ``utils/meters.py`` (numpy copies: equal results), ``utils/captions.py``,
the subset tool ``cli/create_subset.py``, and ``compute_all_scores`` /
``zero_shot_predictions`` (torch against jnp: rtol 1e-5 and 1e-6 of the
largest value, the bound of ``tests/test_torch_scores.py``)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcm_tpu.scores import clip_scores as jscores
from mcm_tpu.utils import captions as jcaptions
from mcm_tpu.utils import meters as jmeters

from mcm_tpu_torch.scores import clip_scores as tscores
from mcm_tpu_torch.utils import captions as tcaptions
from mcm_tpu_torch.utils import meters as tmeters

from util_synth import make_imagefolder_tree


def _feats(rng, b=16, c=7, d=24):
    img = rng.standard_normal((b, d)).astype(np.float32) * 2
    txt = rng.standard_normal((c, d)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    return img, txt


@pytest.mark.parametrize("topk", [(1,), (1, 5), (2, 3)])
def test_accuracy_and_zero_shot_accuracy_equal_jax(rng, topk):
    img, txt = _feats(rng)
    labels = rng.integers(0, 7, size=16)
    logits = rng.standard_normal((16, 7)).astype(np.float32)
    logits[:, 3] = logits[:, 4]           # a tie: the stable sort decides
    assert tmeters.accuracy(logits, labels, topk) == \
        jmeters.accuracy(logits, labels, topk)
    assert tmeters.zero_shot_accuracy(img, txt, labels, topk) == \
        jmeters.zero_shot_accuracy(img, txt, labels, topk)


def test_average_meter_equals_jax():
    t, j = tmeters.AverageMeter(), jmeters.AverageMeter()
    for val, n in [(1.0, 2), (4.0, 1), (0.5, 5)]:
        t.update(val, n)
        j.update(val, n)
    assert vars(t) == vars(j)
    t.reset()
    assert t.count == 0 and t.avg == 0.0


def test_read_file_and_cosine_similarity_equal_jax(rng, tmp_path):
    (tmp_path / "c.txt").write_text("a cat\nthe dog\n\nend")
    assert tmeters.read_file("c.txt", root=str(tmp_path)) == \
        jmeters.read_file("c.txt", root=str(tmp_path)) == \
        ["a cat", "the dog", "", "end"]
    img, txt = _feats(rng)
    np.testing.assert_array_equal(
        tmeters.calculate_cosine_similarity(img, txt),
        jmeters.calculate_cosine_similarity(img, txt))


def test_captions_equal_jax(tmp_path):
    texts, labels = [f"caption {i}" for i in range(5)], list(range(5))
    t, j = tcaptions.TextDataset(texts, labels), \
        jcaptions.TextDataset(texts, labels)
    assert len(t) == len(j) == 5 and t[2] == j[2]
    assert t.batches(2) == j.batches(2)
    with pytest.raises(ValueError):
        tcaptions.TextDataset(texts, labels[:3])
    pytest.importorskip("pandas")
    d = tmp_path / "caps"
    d.mkdir()
    (d / "imagenet_val_captions.tsv").write_text(
        "id\tcap\tcls\n1\ta cat\t0\n2\ta dog\t1\n")
    for multiple in (False, True):
        got = tcaptions.prepare_dataframe(str(d), multiple=multiple)
        want = jcaptions.prepare_dataframe(str(d), multiple=multiple)
        assert got.equals(want)


def test_create_subset_copies_the_listed_classes(tmp_path, capsys):
    from mcm_tpu_torch.cli.create_subset import main
    from mcm_tpu_torch.data.labels import subset_wnids
    wnids = subset_wnids("ImageNet10")
    src = tmp_path / "imagenet"
    for split in ("train", "val"):
        make_imagefolder_tree(str(src / split), wnids + ["n99999999"], 1)
    dst = tmp_path / "out"
    main(["--in_dataset", "ImageNet10", "--src-dir", str(src),
          "--dst-dir", str(dst)])
    for split in ("train", "val"):
        assert sorted(os.listdir(dst / "ImageNet10" / split)) == sorted(wnids)
    # a stale class dir left in the destination is reported
    (dst / "ImageNet10" / "val" / "n00000000").mkdir()
    main(["--in_dataset", "ImageNet10", "--src-dir", str(src),
          "--dst-dir", str(dst)])
    assert "WARNING" in capsys.readouterr().out


@pytest.mark.parametrize("T", [1.0, 3.0])
def test_compute_all_scores_matches_jax(rng, T):
    img, txt = _feats(rng)
    want = jscores.compute_all_scores(jnp.asarray(img), jnp.asarray(txt), T)
    got = tscores.compute_all_scores(torch.from_numpy(img),
                                     torch.from_numpy(txt), T)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_zero_shot_predictions_match_jax(rng):
    img, txt = _feats(rng, b=32)
    j_cls, j_sim = jscores.zero_shot_predictions(jnp.asarray(img),
                                                 jnp.asarray(txt))
    t_cls, t_sim = tscores.zero_shot_predictions(torch.from_numpy(img),
                                                 torch.from_numpy(txt))
    np.testing.assert_array_equal(t_cls.numpy(), np.asarray(j_cls))
    np.testing.assert_allclose(t_sim.numpy(), np.asarray(j_sim), rtol=1e-5,
                               atol=1e-6)

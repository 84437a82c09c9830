"""The port's sklearn-free node-classification F1 against the JAX package's
(sklearn): the F1 arithmetic against ``sklearn.metrics.f1_score`` on fixed
predictions, and the torch L-BFGS classifier against sklearn's
``LogisticRegression`` on the same split (karate embeddings, a separable
3-class set), single- and multi-label.
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn.exceptions import UndefinedMetricWarning
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import f1_score
from sklearn.multiclass import OneVsRestClassifier

from come_tpu.evaluation import node_classification_f1 as j_f1
from come_tpu_torch.config import get_config
from come_tpu_torch.evaluation import (
    f1_train_ratio_sweep,
    node_classification_f1,
)
from come_tpu_torch.evaluation.metrics import classify, f1_scores
from come_tpu_torch.graphs import get_dataset
from come_tpu_torch.trainer import ComETrainer

torch.set_num_threads(2)


def _sk(yt, yp):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UndefinedMetricWarning)
        return {a: f1_score(yt, yp, average=a.split("_")[0])
                for a in ("macro_f1", "micro_f1")}


def _fixed(case):
    rng = np.random.default_rng(4)
    if case == "single":
        yt = rng.integers(0, 5, 60)
        yp = np.where(rng.random(60) < 0.6, yt, rng.integers(0, 7, 60))
        yp[yp == 2] = 3  # class 2 is never predicted
        return yt, yp
    if case == "single_disjoint":
        return np.array([0, 0, 1, 1]), np.array([2, 2, 3, 3])
    yt = (rng.random((50, 6)) < 0.35).astype(np.int64)
    yp = (rng.random((50, 6)) < 0.35).astype(np.int64)
    yp[:, 1] = 0  # never predicted
    yt[:, 4], yp[:, 4] = 0, 0  # neither true nor predicted
    yp[:, 5] = 1 - yt[:, 5]
    return yt, yp


@pytest.mark.parametrize("case", ["single", "single_disjoint", "multi"])
def test_f1_arithmetic_matches_sklearn(case):
    yt, yp = _fixed(case)
    ours, theirs = f1_scores(yt, yp), _sk(yt, yp)
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 1e-12, (k, ours[k], theirs[k])


def _sk_predict(X, y, train_ratio=0.5, seed=0):
    """The JAX package's protocol (come_tpu/evaluation/metrics.py:26-68),
    returning the test ids and sklearn's predictions."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(X.shape[0])
    n_train = max(int(train_ratio * X.shape[0]), 1)
    tr, te = perm[:n_train], perm[n_train:]
    if y.ndim == 1:
        return te, LogisticRegression(max_iter=1000).fit(
            X[tr], y[tr]).predict(X[te])
    probs = OneVsRestClassifier(LogisticRegression(max_iter=1000)).fit(
        X[tr], y[tr]).predict_proba(X[te])
    k = y[te].sum(1).astype(int)
    pred = np.zeros_like(y[te])
    for i in range(len(te)):
        if k[i] > 0:
            pred[i, np.argsort(probs[i])[-k[i]:]] = 1
    return te, pred


_KARATE = {}


def _karate():
    """Embeddings of the port's karate preset (trained once) and a second
    label: nodes of degree above the median."""
    if not _KARATE:
        ds = get_dataset("karate")
        t = ComETrainer(ds.graph, get_config("karate"), "cpu")
        t.train()
        _KARATE["X"] = t.embeddings().astype(np.float64)
        _KARATE["y"] = ds.labels
        deg = ds.graph.degrees
        _KARATE["Y"] = np.stack(
            [ds.labels == 0, ds.labels == 1, deg > np.median(deg)], 1
        ).astype(np.int64)
    return _KARATE


def _three_class(sep):
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(3, 16)) * 3.0
    y = rng.integers(0, 3, 300)
    X = sep * cent[y] + rng.normal(size=(300, 16))
    Y = np.eye(3, dtype=np.int64)[y]
    Y[:, 1] |= (rng.random(300) < 0.3)  # a second label on some nodes
    return X, y, Y


@pytest.mark.parametrize("labels", ["single", "multi"])
@pytest.mark.parametrize("data", ["karate", "separable", "overlapping"])
def test_classifier_matches_sklearn(data, labels):
    if data == "karate":
        d = _karate()
        X, y = d["X"], (d["y"] if labels == "single" else d["Y"])
    else:
        X, y1, Y = _three_class(1.0 if data == "separable" else 0.25)
        y = y1 if labels == "single" else Y
    te, pred = classify(X, y)
    te_sk, pred_sk = _sk_predict(X, y)
    np.testing.assert_array_equal(te, te_sk)
    agree = (pred == pred_sk).all(-1) if y.ndim == 2 else pred == pred_sk
    assert agree.mean() >= 0.99, agree.mean()
    ours = node_classification_f1(X, y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = j_f1(X, y)
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 0.01, (k, ours[k], theirs[k])
    if data == "separable":
        assert ours["macro_f1"] == 1.0 or labels == "multi"


def test_tensor_input_and_sweep():
    X, y, _ = _three_class(1.0)
    emb = torch.as_tensor(X, dtype=torch.float32)
    got = f1_train_ratio_sweep(emb, y, ratios=(0.3, 0.5))
    assert set(got) == {0.3, 0.5}
    assert got[0.5] == node_classification_f1(X.astype(np.float32), y)


def test_two_classes_take_one_sigmoid_as_sklearn():
    """sklearn fits two classes as one binary model (its penalty is not a
    two-column multinomial's): the predictions are sklearn's, named by the
    class labels."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(80, 4))
    y = (X[:, 0] + 0.8 * rng.normal(size=80) > 0).astype(int) + 5
    te, pred = classify(X, y, train_ratio=0.5, seed=2)
    te_sk, pred_sk = _sk_predict(X, y, 0.5, 2)
    np.testing.assert_array_equal(pred, pred_sk)
    assert set(pred) <= {5, 6}

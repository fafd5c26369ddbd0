"""Port parity for the SC09 scoring classifier (``eval/classifier.py``)
and its CLI (``eval/sc09_eval.py``) against the JAX package, on the CPU:

- ``MelCNN`` against flax's on the committed weights and on seeded ones,
  logits and features within 1e-4 x max(1, max |JAX|), on corpus clips
  and on clips whose frame count is odd (123 frames: SAME padding (1, 1)
  at the first layer, where 126 frames pad (0, 1));
- the committed bracket (eval_assets/eval_artifact.json: 0.0146 and
  45.9577, rounded from 0.014615 and 45.957701) within 5e-4 and 5e-3, and
  the corpus classified above 0.9;
- a port-trained classifier loads into JAX's ``load_classifier`` with the
  same ``extract`` within 1e-4; one Adam step from the committed weights
  within 1e-5 of optax's;
- the scoring CLI prints JAX's keys and numbers."""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (torch at one thread)

import jax
import jax.numpy as jnp
import optax

from diffwave_sashimi_tpu.eval import classifier as jax_clf
from diffwave_sashimi_tpu.eval import sc09_eval as jax_sc09_eval
from diffwave_sashimi_torch.eval import classifier as clf
from diffwave_sashimi_torch.eval import sc09_eval
from diffwave_sashimi_torch.eval.fid import frechet_distance, gaussian_stats
from diffwave_sashimi_torch.eval.sc09_eval import _load_dir
from diffwave_sashimi_torch.eval.synth import CLASSES, synth_sc09_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "eval_assets", "classifier_synth.pkl")
TOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return synth_sc09_corpus(str(tmp_path_factory.mktemp("eval") / "c"))


@pytest.fixture(scope="module")
def real(corpus):
    return _load_dir(corpus, 72)


def _seeded_tree(seed=0):
    """The committed tree's shapes, seeded weights (scale and bias of the
    norms away from 1 and 0)."""
    tree = jax_clf.load_classifier(CKPT)[0]["params"]
    rng = np.random.RandomState(seed)
    return {"params": {m: {k: (0.3 * rng.randn(*np.shape(v)) + (
        1.0 if k == "scale" else 0.0)).astype(np.float32)
        for k, v in leaves.items()} for m, leaves in tree.items()}}


def _weights(kind):
    if kind == "committed":
        return jax.tree.map(np.asarray, jax_clf.load_classifier(CKPT)[0])
    return _seeded_tree()


@pytest.mark.parametrize("weights", ["committed", "seeded"])
@pytest.mark.parametrize("clips", ["corpus", "odd_frames"])
def test_melcnn_matches_flax(real, weights, clips):
    audio = real[::3] if clips == "corpus" else real[:5, :15616]
    mel = clf._prep(clf.mel_features(audio))
    assert mel.shape[2] == (126 if clips == "corpus" else 123)
    np.testing.assert_array_equal(mel,
                                  jax_clf._prep(jax_clf.mel_features(audio)))
    params = _weights(weights)
    jlogits, jfeats = jax_clf.MelCNN().apply(params, jnp.asarray(mel))
    model = clf.from_params_tree(params["params"]).eval()
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(mel))
    for mine, ref in ((logits, jlogits), (feats, jfeats)):
        ref = np.asarray(ref)
        err = float(np.abs(mine.numpy() - ref).max())
        assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


def test_same_pads_match_xla():
    for n in range(1, 200):
        assert clf.same_pads(n) == tuple(
            jax.lax.padtype_to_pads((n,), (3,), (2,), "SAME")[0]), n


def test_weights_round_trip_through_the_flax_layout(tmp_path):
    params = _seeded_tree(3)["params"]
    tree = clf.params_tree(clf.from_params_tree(params))
    assert tree.keys() == params.keys()
    for m in params:
        for k in params[m]:
            np.testing.assert_array_equal(tree[m][k], params[m][k])


def test_committed_bracket_and_corpus_accuracy(corpus, real):
    """scripts/eval_artifact.py's bracket with the port's extract on the
    CPU, and the committed classifier's accuracy on its corpus (labels in
    classifier.LABELS order: zero=0, one=1, two=2)."""
    model, meta = clf.load_classifier(CKPT)
    assert meta["acc"] == 1.0 and meta["width"] == 32
    correct = total = 0
    for ci, label in enumerate(CLASSES):
        probs, _ = clf.extract(model, _load_dir(os.path.join(corpus, label),
                                                24), device="cpu")
        correct += int(np.sum(np.argmax(probs, -1) == ci))
        total += len(probs)
    assert correct / total > 0.9, (correct, total)
    _, fa = clf.extract(model, real[0::2], device="cpu")
    _, fb = clf.extract(model, real[1::2], device="cpu")
    noise = (np.random.RandomState(1)
             .randn(36, real.shape[1]).astype(np.float32) * 0.1)
    _, fn = clf.extract(model, noise, device="cpu")
    split = frechet_distance(*gaussian_stats(fa), *gaussian_stats(fb))
    vs_noise = frechet_distance(*gaussian_stats(fa), *gaussian_stats(fn))
    with open(os.path.join(REPO, "eval_assets", "eval_artifact.json")) as f:
        art = json.load(f)
    assert abs(split - art["fid_real_vs_real_split"]) <= 5e-4, split
    assert abs(vs_noise - art["fid_real_vs_noise"]) <= 5e-3, vs_noise


def test_extract_matches_jax_on_the_committed_weights(real):
    params, _ = jax_clf.load_classifier(CKPT)
    jprobs, jfeats = jax_clf.extract(params, real[:24], batch=10)
    probs, feats = clf.extract(clf.load_classifier(CKPT)[0], real[:24],
                               batch=10, device="cpu")
    for mine, ref in ((probs, jprobs), (feats, jfeats)):
        err = float(np.abs(mine - ref).max())
        assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


def test_port_trained_classifier_loads_into_jax(tmp_path):
    """One epoch on a tiny tree (4 clips a class, batch 4: 3 steps), then
    JAX's load_classifier and extract on the file the port wrote."""
    tree = synth_sc09_corpus(str(tmp_path / "tiny"), n_per_class=4, seed=2)
    path = str(tmp_path / "clf.pkl")
    out = clf.train_classifier(tree, path, epochs=1, batch=4, device="cpu")
    assert out["iter"] == 2 and np.isfinite(out["loss"])
    params, meta = jax_clf.load_classifier(path)
    assert meta == {"width": 32, "epochs": 1, "iter": 2, "epoch": 0,
                    "loss": out["loss"], "acc": out["acc"]}
    audio = _load_dir(tree, 12)
    jprobs, jfeats = jax_clf.extract(params, audio)
    probs, feats = clf.extract(clf.load_classifier(path)[0], audio,
                               device="cpu")
    for mine, ref in ((probs, jprobs), (feats, jfeats)):
        err = float(np.abs(mine - ref).max())
        assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


def test_one_adam_step_matches_optax(real):
    """classifier_step (torch Adam at lr 1e-3) against JAX's step (optax
    adam) from the committed weights on one batch of 8: the loss within
    1e-5, the accuracy equal, every gradient within 1e-5 of its tensor's
    max |JAX grad|, and every weight after the step within 1e-5 of optax's
    wherever |JAX grad| >= 1e-6.  Adam's first step moves a weight by
    lr g / (|g| + 1e-8): where |g| is near 1e-8 (13565 of conv3's weights
    have |g| < 1e-7, below ReLUs that are off) it turns gradients that
    agree to 3e-10 into steps that differ by up to 2.4e-5; there the
    weights are held to that step's bound, 2 lr."""
    params = jax.tree.map(jnp.asarray, jax_clf.load_classifier(CKPT)[0])
    audio = real[::9]
    labels = np.arange(len(audio)) % 3
    mel = clf._prep(clf.mel_features(audio))
    model = jax_clf.MelCNN()
    opt = optax.adam(1e-3)

    def loss_fn(p):
        logits, _ = model.apply(p, jnp.asarray(mel))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    @jax.jit
    def step(p):
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, _ = opt.update(g, opt.init(p))
        return loss, logits, g, optax.apply_updates(p, upd)
    jloss, jlogits, jgrads, jparams = step(params)

    port = clf.load_classifier(CKPT)[0]
    loss, acc = clf.classifier_step(
        port, torch.optim.Adam(port.parameters(), lr=1e-3),
        torch.from_numpy(mel), torch.from_numpy(labels))
    assert abs(loss - float(jloss)) <= 1e-5
    assert acc == float(np.mean(np.argmax(np.asarray(jlogits), -1) == labels))
    held = clf.MelCNN()             # the gradients, in the flax layout
    with torch.no_grad():
        for h, p in zip(held.parameters(), port.parameters()):
            h.copy_(p.grad)
    grads = clf.params_tree(held)
    mine = clf.params_tree(port)
    for m, leaves in jparams["params"].items():
        for k, ref in leaves.items():
            g = np.asarray(jgrads["params"][m][k])
            assert float(np.abs(grads[m][k] - g).max()) <= 1e-5 * float(
                np.abs(g).max()), (m, k)
            err = np.abs(mine[m][k] - np.asarray(ref))
            conditioned = np.abs(g) >= 1e-6
            assert float(err[conditioned].max()) <= 1e-5, (m, k)
            assert float(err.max()) <= 2e-3, (m, k)


def test_sc09_eval_cli_prints_jax_keys(corpus, capsys):
    argv = ["score", "--real", corpus, "--generated",
            os.path.join(corpus, "one"), "--classifier", CKPT, "--n", "30"]
    mine = sc09_eval.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = jax_sc09_eval.main(argv)
    assert printed == mine and list(mine) == list(ref)
    assert (mine["n_real"], mine["n_generated"]) == (30, 24)
    assert mine["classifier_train_acc"] == ref["classifier_train_acc"]
    for k in ("fid", "is", "is_std"):
        assert abs(mine[k] - ref[k]) <= 2e-4 * max(1.0, abs(ref[k])), k


def test_sc09_eval_cli_trains(tmp_path, capsys):
    tree = synth_sc09_corpus(str(tmp_path / "tiny"), n_per_class=2, seed=4)
    path = str(tmp_path / "c.pkl")
    out = sc09_eval.main(["train", "--data", tree, "--classifier", path,
                          "--epochs", "1", "--batch", "6", "--device",
                          "cpu"])
    assert list(out) == ["classifier", "final_loss", "final_acc"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert os.path.exists(path) and np.isfinite(out["final_loss"])

"""Port parity for the evaluation's numpy parts: FID and IS bit-equal to the
JAX package's on the same seeded features, the synthetic corpus byte-equal
to JAX's for the same (n_per_class, seed), the eval package's exports, and
a scan of the port's sources for imports of jax, flax, optax or the JAX
package (the port keeps its own copies)."""

import ast
import os
import re

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (torch at one thread)

from diffwave_sashimi_tpu import eval as jax_eval
from diffwave_sashimi_tpu.eval import fid as jax_fid
from diffwave_sashimi_tpu.eval import synth as jax_synth
from diffwave_sashimi_torch import eval as port_eval
from diffwave_sashimi_torch.eval import fid, synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffwave_sashimi_tpu")


def _features(n, d, seed, shift=0.0):
    rng = np.random.RandomState(seed)
    mix = rng.randn(d, d) / np.sqrt(d)
    return (rng.randn(n, d) @ mix + shift).astype(np.float32)


@pytest.mark.parametrize("n, d, seed", [(36, 128, 0), (200, 8, 1),
                                        (5, 16, 2), (72, 1, 3)])
def test_frechet_distance_is_bit_equal_to_jax(n, d, seed):
    a, b = _features(n, d, seed), _features(n + 3, d, seed + 10, 0.3)
    mine = fid.frechet_distance(*fid.gaussian_stats(a),
                                *fid.gaussian_stats(b))
    ref = jax_fid.frechet_distance(*jax_fid.gaussian_stats(a),
                                   *jax_fid.gaussian_stats(b))
    assert mine == ref and np.isfinite(mine)
    for x, y in zip(fid.gaussian_stats(a), jax_fid.gaussian_stats(a)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("n, splits", [(72, 10), (36, 1), (8, 10),
                                       (100, 3)])
def test_inception_score_is_bit_equal_to_jax(n, splits):
    rng = np.random.RandomState(n)
    logits = 3.0 * rng.randn(n, 10)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    mine = fid.inception_score(probs, splits=splits)
    assert mine == jax_fid.inception_score(probs, splits=splits)
    assert all(np.isfinite(mine))


@pytest.mark.parametrize("n_per_class, seed", [(24, 0), (2, 7)])
def test_synthetic_corpus_is_byte_equal_to_jax(tmp_path, n_per_class, seed):
    mine = synth.synth_sc09_corpus(str(tmp_path / "port"), n_per_class, seed)
    ref = jax_synth.synth_sc09_corpus(str(tmp_path / "jax"), n_per_class,
                                      seed)
    assert synth.CLASSES == jax_synth.CLASSES
    names = sorted(os.path.relpath(os.path.join(d, f), mine)
                   for d, _, fs in os.walk(mine) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), ref)
                           for d, _, fs in os.walk(ref) for f in fs)
    assert len(names) == n_per_class * len(synth.CLASSES)
    for name in names:
        with open(os.path.join(mine, name), "rb") as f, \
                open(os.path.join(ref, name), "rb") as g:
            assert f.read() == g.read(), name


def test_eval_package_exports_match_jax():
    assert port_eval.__all__ == jax_eval.__all__
    from diffwave_sashimi_tpu.eval import classifier as jax_clf
    from diffwave_sashimi_torch.eval import classifier as clf
    assert set(jax_clf.__all__) <= set(clf.__all__)
    assert (clf.LABELS, clf.N_MELS, clf.HOP, clf.SR) == (
        jax_clf.LABELS, jax_clf.N_MELS, jax_clf.HOP, jax_clf.SR)


def _port_sources():
    root = os.path.join(REPO, "diffwave_sashimi_torch")
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".py"))


def test_port_sources_import_nothing_of_jax():
    """Every module of the port, the eval package among them: no import
    statement (at any depth) and no ``import_module``/``__import__`` call
    names jax, flax, optax or the JAX package."""
    files = _port_sources()
    assert any(f.endswith(os.path.join("eval", "flagship.py"))
               for f in files)
    dynamic = re.compile(r"(import_module|__import__)\(\s*['\"](%s)\b"
                         % "|".join(FORBIDDEN))
    bad = []
    for path in files:
        with open(path) as f:
            src = f.read()
        for node in ast.walk(ast.parse(src, path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names
                    if n.split(".")[0] in FORBIDDEN]
        bad += [(path, m.group(0)) for m in dynamic.finditer(src)]
    assert not bad, bad

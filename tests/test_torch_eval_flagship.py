"""The training side of the evaluation loop on the CPU: ``train.main``
with ``compute.remat=true`` trains bit for bit as without,
``train(data_loader=...)`` replaces the config's loader, and the port's
flagship FID loop (``eval/flagship.py``) runs end to end on a tiny model."""

import json
import os

import numpy as np
import torch

import test_torch_common  # noqa: F401  (torch at one thread)
from test_torch_common import SMALL_CFG

from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.data import dataloader
from diffwave_sashimi_torch.eval import flagship
from diffwave_sashimi_torch.eval.synth import synth_sc09_corpus
from diffwave_sashimi_torch.runtime import train as port_train
from diffwave_sashimi_torch.utils.exp import local_directory

DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
# the smallest experiment=sc09 model and its 3-iteration training run
SMALL_OVERRIDES = ["experiment=sc09", "model.d_model=8", "model.n_layers=1",
                   "compute.precision=f32", "mesh.data=1",
                   "generate.n_samples=0", "train.n_iters=2",
                   "train.iters_per_ckpt=2", "train.iters_per_logging=1",
                   "train.batch_size_per_gpu=2", "+train.device=cpu"]


def test_train_main_with_remat_trains_as_without(tmp_path, monkeypatch):
    corpus = synth_sc09_corpus(str(tmp_path / "c"), n_per_class=2)
    monkeypatch.chdir(tmp_path)
    runs = {}
    for remat in ("false", "true"):
        argv = SMALL_OVERRIDES + [f"dataset.data_path={corpus}",
                                  f"compute.remat={remat}",
                                  f"train.name=remat_{remat}"]
        port_train.main(argv)
        cfg = load_config(overrides=argv)
        run, _ = local_directory(cfg.train.name, cfg.model, cfg.diffusion,
                                 cfg.dataset, "checkpoint", makedirs=False)
        with open(os.path.join("exp", run, "metrics.jsonl")) as f:
            losses = [r["train/loss"] for r in map(json.loads, f)
                      if "train/loss" in r]
        runs[remat] = losses, torch.load(
            os.path.join("exp", run, "checkpoint", "2.pkl"),
            weights_only=True)["model_state_dict"]
    assert len(runs["true"][0]) == 3 and runs["true"][0] == runs["false"][0]
    for k, v in runs["false"][1].items():
        assert torch.equal(v, runs["true"][1][k]), k


def test_train_takes_a_data_loader(tmp_path, monkeypatch):
    """``data_loader`` replaces the config's loader: the first epoch of the
    config's own loader, handed over as a list, trains bit for bit as the
    config's loader does, and the config's data_path is not read."""
    corpus = synth_sc09_corpus(str(tmp_path / "c"), n_per_class=2)
    data = {"_name_": "sc09", "data_path": corpus, "segment_length": 16000,
            "sampling_rate": 16000}
    monkeypatch.chdir(tmp_path)
    batches = list(dataloader(data, batch_size=2))
    assert len(batches) == 3
    kw = dict(n_iters=2, iters_per_ckpt=10, iters_per_logging=1,
              batch_size_per_gpu=2, compute_cfg={"precision": "f32"},
              device="cpu")
    ref = port_train.train(DIFFUSION, SMALL_CFG, data, None, name="cfg",
                           **kw)
    mine = port_train.train(DIFFUSION, SMALL_CFG,
                            dict(data, data_path=str(tmp_path / "none")),
                            None, name="list", data_loader=batches, **kw)
    assert [i for i, _ in mine["losses"]] == [0, 1, 2]
    assert mine["losses"] == ref["losses"]
    for (k, a), b in zip(mine["model"].state_dict().items(),
                         ref["model"].state_dict().values()):
        assert torch.equal(a, b), k


def test_flagship_runs_on_the_cpu(tmp_path, capsys):
    """The protocol end to end at d8 n1 L4000 and T 50: one banked
    checkpoint scored at T 50 and both T6 schedules; the artifact lands
    in the workdir, with finite FID and IS; the cwd is restored."""
    cwd = os.getcwd()
    work = tmp_path / "ws"
    art = flagship.main([
        "--cpu", "--d-model", "8", "--iters", "2", "--batch", "2",
        "--n-gen", "2", "--gen-batch", "1", "--workdir", str(work),
        "--out", "art.json", "--override", "model.n_layers=1",
        "--override", "model.L=4000", "--override",
        "dataset.segment_length=4000", "--override", "diffusion.T=50",
        "--override", "diffusion.beta_T=0.05"])
    assert os.getcwd() == cwd
    with open(work / "art.json") as f:
        assert json.load(f) == art
    assert [p["iter"] for p in art["trend_T200"]] == [2]
    points = art["trend_T200"] + [art["fast_T6_aligned"],
                                  art["fast_T6_raw_ref_behavior"]]
    assert all(np.isfinite(p["fid"]) and np.isfinite(p["is"])
               for p in points)
    assert art["model"] == "sashimi d8 n1 pool(4,4) (2 iters, CPU, B2)"
    run = os.listdir(work / "exp")[0]
    assert sorted(os.listdir(work / "exp" / run / "waveforms")) == [
        "2_T200", "2_T6aligned", "2_T6raw"]
    assert "[flagship] iter 2 T6raw" in capsys.readouterr().out

"""The affordance package's entry points against the JAX package, on the CPU.

Every ``aff_detection`` group takes a train step (``train_affordance``'s,
on synthetic frames);
three train steps of ``rn18_pixel`` (sentence embeddings), ``rn18_clip_mask``
(mask labels) and a trainable ``r3m_pixel`` equal JAX's on the same
weights, batches and crop offsets; ``train_depth``'s objective; the
labelled-dir path with hash sentence embeddings behind the stub gate;
``merge_datasets``'s split file; the evaluator's table for a detector over
sentence embeddings (from ``--aff-lang-embeddings`` or the dataset's
annotations); and the hierarchical CLI chain of a ``cfg_low_level`` policy
with an ``rn18_pixel`` detector. Small sizes: decoder (32, 16, 8, 8, 8),
64 px, 16-d language, batch 2.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_affordance import HW, SMALL, build_pair, configs
from hulc2_torch.affordance import merge_datasets, train_affordance, train_depth
from hulc2_torch.affordance.train_affordance import SyntheticAffordanceDataset
from hulc2_torch.core.config import options
from hulc2_torch.evaluation import evaluate_policy
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.utils.convert import detector_flax_to_torch

RUN = [*SMALL, "batch_size=2", "num_workers=1"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These small models gain nothing from torch's thread pool, and under
    pytest-xdist its threads would contend with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.mark.parametrize("group", sorted(options("aff_detection")))
def test_group_trains_a_step(group):
    """One synthetic train step of each group's detector: finite metrics of
    its loss (mask terms for mask labels), and a frozen encoder (R3M's stem
    through layer3) bit for bit as built."""
    from hulc2_torch.tools.profile_affordance import synthetic_train_step

    extra = ["aff_detection.tower_width=32", "aff_detection.tower_heads=2"] \
        if group == "rn18_tokens_pixel" else []
    cfg = configs(group, [*RUN, *extra])[1]
    aff = cfg["aff_detection"]
    model, step = synthetic_train_step(cfg, torch.device("cpu"), frame_hw=48, n_batches=1)
    fresh = {k: v.clone() for k, v in model.aff_stream.encoder.state_dict().items()}
    line = {k: v.item() for k, v in step().items()}
    assert all(np.isfinite(v) for v in line.values())
    assert ("miou" in line) == (aff["dataset"].get("label_type") == "mask")
    assert ("aff_loss" in line) != ("mask_bce" in line) and "depth_loss" in line
    now = model.aff_stream.encoder.state_dict()
    frozen = [k for k in fresh if aff["freeze_encoder"] or not k.startswith("layer4_")]
    assert frozen and all(torch.equal(fresh[k], now[k]) for k in frozen)
    assert aff["freeze_encoder"] or any(not torch.equal(fresh[k], now[k]) for k in fresh)


def _jax_steps(jcfg, variables, raws, keys):
    from hulc2_tpu.affordance.train_affordance import build_detector as jax_build
    from hulc2_tpu.affordance.train_affordance import make_aff_train_step as jax_make_step
    from hulc2_tpu.train import optim as jax_optim

    aff = jcfg["aff_detection"]
    jmodel = jax_build(aff)
    tx = jax_optim.make_optimizer(aff["optimizer"])
    step = jax_make_step(jmodel, tx, aff["loss_weights"], HW, jcfg["rand_shift_pad"],
                         aff["dataset"].get("label_type", "pixel"))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state, out = tx.init(params), []
    for raw, key in zip(raws, keys):
        params, stats, opt_state, m = step(params, stats, opt_state,
                                           {k: jnp.asarray(v) for k, v in raw.items()}, key)
        out.append({k: float(v) for k, v in m.items()})
    return out, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("group", ["rn18_pixel", "rn18_clip_mask", "r3m_pixel"])
def test_three_train_steps_equal_jax(group):
    """Three steps on the same batches and crop offsets: every loss and metric
    within rtol 1e-3 of JAX's; the frozen encoder levels bit for bit as
    loaded, R3M's layer4 moved and within 1e-3 of JAX's."""
    jcfg, _, variables, tmodel, pcfg = build_pair(group, seed=20)
    aff, pad = pcfg["aff_detection"], pcfg["rand_shift_pad"]
    labels = aff["dataset"].get("label_type", "pixel")
    ds = SyntheticAffordanceDataset(6, 48, aff["lang_embed_dim"], seed=21, label_type=labels)
    keys = [jax.random.PRNGKey(22 + s) for s in range(3)]
    raws = []
    for s in range(3):
        items = [ds[2 * s + i] for i in range(2)]
        raw = {k: np.stack([it[k] for it in items]) for k in items[0] if k != "idx"}
        raw["px"] = (raw["px"] * HW // 48).astype(np.int32)
        if labels == "mask":  # the mask at the model's input size
            idx = np.arange(HW) * 48 // HW
            raw["mask"] = raw["mask"][:, idx][:, :, idx]
        raws.append(raw)
    want, jvars = _jax_steps(jcfg, variables, raws, keys)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    opt = make_optimizer(tmodel.parameters(), aff["optimizer"])
    step = train_affordance.make_aff_train_step(tmodel, opt, aff["loss_weights"], HW, pad, labels)
    for raw, key, w in zip(raws, keys, want):
        offsets = np.asarray(jax.random.randint(key, (2, 2), 0, 2 * pad + 1), np.int32)
        got = step({k: torch.from_numpy(v) for k, v in raw.items()}, torch.from_numpy(offsets))
        assert sorted(got) == sorted(w)
        for k in w:
            np.testing.assert_allclose(got[k].item(), w[k], rtol=1e-3, atol=1e-6, err_msg=k)
    final = detector_flax_to_torch(jax.tree_util.tree_map(np.asarray, jvars), aff)
    now = tmodel.state_dict()
    enc = [k for k in now if k.startswith("aff_stream.encoder.")]
    trained = [k for k in enc if not aff["freeze_encoder"] and ".layer4_" in k]
    for k in enc:
        if k in trained:
            assert not torch.equal(now[k], before[k]) or "running" in k, k
            np.testing.assert_allclose(now[k].numpy(), final[k].numpy(), atol=1e-3, err_msg=k)
        else:
            assert torch.equal(now[k], before[k]), k
    assert bool(trained) == (group == "r3m_pixel")


def test_train_depth_trains_the_depth_objective(tmp_path):
    """``train_depth aff_detection=rn18_pixel``: JAX's composition of that
    group with the depth-only settings (aff weight 0, depth 1, the encoder
    trainable), a step whose total is its depth loss, and an encoder that
    moved."""
    from hulc2_tpu.core import config as jax_cfg_lib

    res = train_depth.main(["--synthetic", "--device", "cpu", "--max-steps", "1", "--max-epochs",
                            "1", "--run-dir", str(tmp_path), "aff_detection=rn18_pixel", *RUN])
    cfg = json.loads((tmp_path / "config.json").read_text())
    want = jax_cfg_lib.compose("train_affordance",
                               ["aff_detection=rn18_pixel", *train_depth.DEPTH_ONLY, *RUN])
    assert {k: v for k, v in cfg.items() if k != "depth_norm"} == want
    line = res.history[0]
    assert line["total_loss"] == pytest.approx(line["depth_loss"], rel=1e-6)
    fresh = train_affordance.build_detector(cfg["aff_detection"], 42).state_dict()
    now = res.model.state_dict()
    assert any(not torch.equal(fresh[k], now[k]) for k in fresh
               if k.startswith("aff_stream.encoder.") and k.endswith("weight"))


def _labelled_dir(root, n=4, seed=0):
    """A mined-labels dir of ``n`` 48 px frames in one training and one
    validation episode, one without a stored mask."""
    rng = np.random.default_rng(seed)
    split = {"training": {}, "validation": {},
             "norm_values": {"depth": {"static_cam": {"mean": 2.0 + seed, "std": 0.5}}}}
    for s, ep in (("training", "episode_0"), ("validation", "validation_episode_0")):
        cam = root / ep / "data" / "static_cam"
        cam.mkdir(parents=True)
        files = []
        for i in range(n):
            np.savez(cam / f"frame_{i}.npz", frame=rng.integers(0, 256, (48, 48, 3), np.uint8),
                     centers=np.array([[0, *rng.integers(0, 48, 2)]]), depth=2.0 + i,
                     lang_ann=f"push the button {i % 2}")
            files.append(f"frame_{i}")
        split[s][ep] = {"static_cam": files}
    (root / "episodes_split.json").write_text(json.dumps(split))
    return root


def test_labelled_dir_with_sentence_embeddings(tmp_path, monkeypatch):
    """``rn18_clip_mask`` from a labelled dir: the annotations' ``hash_embed``
    at the detector's width (the same vectors as JAX's), synthesized masks,
    one step and a validation; without ``HULC2_ALLOW_STUB_EMBEDDINGS`` the
    trainer refuses, as JAX's does."""
    from hulc2_tpu.tools.auto_lang_annotator import hash_embed as jax_hash

    data = _labelled_dir(tmp_path / "data")
    args = ["aff_detection=rn18_clip_mask", *RUN, f"aff_detection.dataset.data_dir={data}"]
    embed = train_affordance.language_embedder(configs("rn18_clip_mask")[1]["aff_detection"])
    np.testing.assert_array_equal(embed("push the button 1"), jax_hash(["push the button 1"], 16)[0])
    res = train_affordance.train(args, max_epochs=1, run_dir=tmp_path / "run", device="cpu")
    assert res.step == 2 and {"miou", "dice_loss", "mask_bce"} <= set(res.history[0])
    assert json.loads((tmp_path / "run" / "config.json").read_text())["depth_norm"] == {
        "mean": 2.0, "std": 0.5}
    monkeypatch.delenv("HULC2_ALLOW_STUB_EMBEDDINGS")
    with pytest.raises(RuntimeError, match="HULC2_ALLOW_STUB_EMBEDDINGS"):
        train_affordance.train(args, max_epochs=1, run_dir=tmp_path / "run2", device="cpu")


@pytest.mark.parametrize("copy", [False, True], ids=["linked", "copied"])
def test_merge_datasets_equals_jax(tmp_path, copy):
    """Two labelled dirs merged by both packages: the same split file, the
    pooled depth statistics, and episodes readable through the merge."""
    from hulc2_tpu.affordance.merge_datasets import merge_datasets as jax_merge

    srcs = [_labelled_dir(tmp_path / name, n, seed) for name, n, seed in
            (("calvin", 3, 0), ("real", 5, 1))]
    ours = merge_datasets.main([str(tmp_path / "ours"), *map(str, srcs)] + (["--copy"] if copy else []))
    theirs = jax_merge(tmp_path / "theirs", srcs, copy)
    assert ours == theirs
    assert (tmp_path / "ours" / "episodes_split.json").read_text() == \
        (tmp_path / "theirs" / "episodes_split.json").read_text()
    assert len(ours["training"]) == 2 and len(ours["validation"]) == 2
    for ep in ours["training"]:
        assert (tmp_path / "ours" / ep).is_symlink() != copy
    from hulc2_torch.affordance.dataset import AffordanceDataset

    merged = AffordanceDataset(tmp_path / "ours", img_resize=HW)
    assert len(merged) == 8 and merged.depth_norm.std > 0.5


def _embeddings_file(path, dim):
    from hulc2_torch.evaluation.tasks import TASK_NAMES
    from hulc2_torch.tools.annotations import VALIDATION_BANK

    rng = np.random.default_rng(dim)
    np.save(path, {t: {"ann": [VALIDATION_BANK[t]], "emb": rng.standard_normal((1, dim))}
                   for t in TASK_NAMES}, allow_pickle=True)
    return path


def test_detector_table_equals_jax(tmp_path):
    """The sentence detector's goals: from an ``--aff-lang-embeddings`` file,
    and JAX's ``hash_embed`` of the dataset's canonical annotations at the
    detector's width; the caption table maps each sentence to its goal."""
    from hulc2_tpu.evaluation.evaluate_policy import load_lang_embeddings_file as jax_load
    from hulc2_tpu.tools.auto_lang_annotator import hash_embed as jax_hash
    from hulc2_torch.tools.annotations import VALIDATION_BANK

    f = _embeddings_file(tmp_path / "emb.npy", 16)
    ann_emb, t2a = jax_load(f)
    goals, table = evaluate_policy.sentence_detector_goals(16, str(f), None, "lang_annotations")
    assert sorted(goals) == sorted(t2a)
    for t, a in t2a.items():
        assert goals[t].dtype == np.float32
        np.testing.assert_array_equal(goals[t], np.asarray(ann_emb[a], np.float32))
        np.testing.assert_array_equal(table[a], goals[t])
    (tmp_path / "ds" / "validation" / "lang_annotations").mkdir(parents=True)
    _embeddings_file(tmp_path / "ds" / "validation" / "lang_annotations" / "embeddings.npy", 8)
    goals, table = evaluate_policy.sentence_detector_goals(24, None, str(tmp_path / "ds"),
                                                           "lang_annotations")
    assert sorted(goals) == sorted(VALIDATION_BANK)
    for t, a in VALIDATION_BANK.items():
        np.testing.assert_array_equal(goals[t], jax_hash([a], 24)[0])
        np.testing.assert_array_equal(table[a], goals[t])


def _spy(monkeypatch):
    from hulc2_torch.evaluation import batched_eval

    made = []

    class Spy(batched_eval.PipelinedEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(batched_eval, "PipelinedEvaluator", Spy)
    return made


def test_sentence_detector_cli_chain_on_cpu(tmp_path, monkeypatch, caplog):
    """A saved ``rn18_pixel`` run, then the hierarchical eval of a
    ``cfg_low_level`` policy with it: the detector's
    goals are the hash embeddings of the dataset's annotations (JAX's
    table), the counters are logged, approaches taken. Then a token policy
    with ``--aff-lang-embeddings`` under ``--paraphrase-eval``: the policy
    gets the held-out sentences, the detector keeps the file's canonical
    embeddings, as in JAX; without the file it is refused."""
    from hulc2_tpu.evaluation.evaluate_policy import load_lang_embeddings as jax_load
    from hulc2_tpu.tools.auto_lang_annotator import hash_embed as jax_hash
    from test_torch_port_embedding_eval import _embedding_run
    from test_torch_port_eval_host import TINY
    from test_torch_port_host_loader import write_low_level_dir

    from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config

    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    # the chain generator's process pool would spawn a process per core; the
    # in-process path gives the same chains
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    data = write_low_level_dir(tmp_path / "data", 16, 16)
    aff = tmp_path / "aff"
    cfg = configs("rn18_pixel", RUN)[1]
    save_run_config(aff, {**cfg, "depth_norm": {"mean": 0.0, "std": 1.0}})
    CheckpointManager(aff).save(1, train_affordance.build_detector(cfg["aff_detection"]), None)
    run = _embedding_run(tmp_path / "run")
    made = _spy(monkeypatch)
    common = ["--fake-env", "--device-render", "--n-envs", "3", "--cohorts", "2",
              "--num-sequences", "3", "--ep-len", "4", "--device", "cpu", "--aff-train-dir", str(aff)]
    with caplog.at_level(logging.INFO, logger="hulc2_torch.evaluation.evaluate_policy"):
        evaluate_policy.main(["--train-dir", str(run), "--dataset-path", str(data), *common])
    (ev,) = made
    _, task_to_ann = jax_load(data, "lang_annotations")
    assert sorted(ev.aff_lang) == sorted(task_to_ann)
    for t, a in task_to_ann.items():
        np.testing.assert_array_equal(ev.aff_lang[t], jax_hash([a], 16)[0])
    assert ev.aff_lang_variants is None and not ev.affordance.uses_tokens
    diag = json.loads((run / "evaluation" / "eval_diagnostics.json").read_text())
    h = diag["hierarchical"]
    assert h["aff_predictions"] == len(diag["subtask_records"]) and h["approaches"] > 0
    assert any(r.getMessage().startswith("hierarchical mode") for r in caplog.records)

    emb = _embeddings_file(tmp_path / "emb.npy", 16)
    evaluate_policy.main(["--synthetic", "--paraphrase-eval", "--aff-lang-embeddings", str(emb),
                          "--log-dir", str(tmp_path / "para"), *common, *TINY])
    ev = made[-1]
    assert ev.lang_variants is not None and ev.aff_lang_variants is None
    goals, _ = evaluate_policy.sentence_detector_goals(16, str(emb), None, "lang_annotations")
    assert all(np.array_equal(ev.aff_lang[t], goals[t]) for t in goals)
    with pytest.raises(SystemExit):
        evaluate_policy.main(["--synthetic", *common, *TINY])

"""Feature extraction in the port against the JAX package: the same tiny
JPEG dataset as tests/test_extraction.py, the same tiny tower weights
(``state_dict_from_flax``), fp32, written through each package's
``ensure_features``; the caches (softmax at several T, text, visual) agree
within 1e-4 and the second call is a cache hit. Also the copied tokenizer,
data layer and CLI option checks against the JAX originals."""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_clip
from test_convert import TINY_VIT

from transductive_clip_tpu.cli import maybe_load_clip as jax_maybe_load_clip
from transductive_clip_tpu.core.config import CfgNode as JaxCfgNode
from transductive_clip_tpu.core.config import load_full_config as jax_config
from transductive_clip_tpu.data import build_dataset as jax_build_dataset
from transductive_clip_tpu.data import iter_image_batches as jax_iter_batches
from transductive_clip_tpu.eval.extraction import (
    ensure_features as jax_ensure_features,
)
from transductive_clip_tpu.features.cache import (
    load_feature_cache as jax_load_cache,
)
from transductive_clip_tpu.models.clip import JaxCLIP
from transductive_clip_tpu.models.clip.convert import convert_openai_checkpoint
from transductive_clip_tpu.models.clip.preprocess import (
    make_preprocess as jax_preprocess,
)
from transductive_clip_tpu.models.clip.tokenizer import (
    SimpleTokenizer as JaxTokenizer,
)
from transductive_clip_tpu_torch import cli
from transductive_clip_tpu_torch.core.config import CfgNode, load_full_config
from transductive_clip_tpu_torch.core.io import load_pickle
from transductive_clip_tpu_torch.data import build_dataset, iter_image_batches
from transductive_clip_tpu_torch.eval import EvaluatorZeroShot
from transductive_clip_tpu_torch.eval.extraction import (
    ensure_features,
    extract_to_caches,
    text_cache_path,
)
from transductive_clip_tpu_torch.features.cache import load_feature_cache
from transductive_clip_tpu_torch.models.clip import TorchCLIP
from transductive_clip_tpu_torch.models.clip.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.convert import (
    state_dict_from_flax,
)
from transductive_clip_tpu_torch.models.clip.preprocess import make_preprocess
from transductive_clip_tpu_torch.models.clip.tokenizer import SimpleTokenizer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
TOL = dict(rtol=1e-4, atol=1e-4)
# TINY_VIT with a vocabulary that holds the tokenizer's ids (SOT/EOT are
# 517/518 with the synthetic merges) and room for a prompt
CFG = dataclasses.replace(TINY_VIT, text=dataclasses.replace(
    TINY_VIT.text, vocab_size=520, context_length=24))
MERGES = ["#version: 0.2", "c a", "ca t</w>", "d o", "do g</w>", "a t</w>"]


@pytest.fixture
def bpe(tmp_path, monkeypatch):
    """The synthetic merges file of tests/test_tokenizer.py, as
    $CLIP_BPE_PATH."""
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt") as f:
        f.write("\n".join(MERGES) + "\n")
    monkeypatch.setenv("CLIP_BPE_PATH", str(path))
    return str(path)


@pytest.fixture
def image_dataset(tmp_path, monkeypatch):
    """tests/test_extraction.py's dataset: 3 splits x 3 classes x 4 JPEGs."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    root = "data/eurosat"
    img_dir = os.path.join(root, "images", "classA")
    os.makedirs(img_dir)
    split = {"train": [], "val": [], "test": []}
    for split_name in split:
        for c in range(3):
            for i in range(4):
                name = f"classA/{split_name}_{c}_{i}.jpg"
                Image.fromarray(
                    rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                ).save(os.path.join(root, "images", name))
                split[split_name].append([name, c, f"class {c}"])
    with open(os.path.join(root, "split_zhou_EuroSAT.json"), "w") as f:
        json.dump(split, f)
    return root


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, port model) on the same fp32 tiny weights."""
    sd = torch_clip.synth_state_dict(CFG, seed=0)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    torch.save(sd, path)
    params = convert_openai_checkpoint(path, CFG)
    jax_model = JaxCLIP(CFG, params, compute_dtype=jnp.float32,
                        attention_impl="xla")
    port_cfg = CLIPConfig(
        name=CFG.name, embed_dim=CFG.embed_dim,
        vision=CLIPVisionConfig(**dataclasses.asdict(CFG.vision)),
        text=CLIPTextConfig(**dataclasses.asdict(CFG.text)))
    port_model = TorchCLIP(port_cfg, state_dict_from_flax(params, CFG),
                           compute_dtype=torch.float32, device="cpu")
    return jax_model, port_model


def _cfg(cls, dataset, softmax, **kw):
    return cls(dict(dict(dataset="eurosat", dataset_path=dataset,
                         backbone="RN50", T=30, use_softmax_feature=softmax,
                         root="data", extract_batch_size=5), **kw))


def _feature_dir(side):
    return os.path.join(side, "eurosat", "saved_features")


@pytest.mark.parametrize("softmax", [True, False], ids=["softmax", "visual"])
def test_ensure_features_matches_jax(image_dataset, bpe, models, softmax):
    jax_model, port_model = models
    size = CFG.vision.image_size
    list_T = [10, 30] if softmax else None
    splits = ("test", "train")
    jax_ensure_features(
        _cfg(JaxCfgNode, image_dataset, softmax, root="jax"), jax_model,
        jax_preprocess(size, dtype="uint8"), splits=splits, list_T=list_T)
    cfg = _cfg(CfgNode, image_dataset, softmax, root="port")
    ensure_features(cfg, port_model, make_preprocess(size, dtype="uint8"),
                    splits=splits, list_T=list_T)
    names = sorted(os.listdir(_feature_dir("jax")))
    assert names == sorted(os.listdir(_feature_dir("port")))
    assert len(names) == (5 if softmax else 2)   # 2 splits x 2 T + text
    for name in names:
        if name.startswith("text_"):
            want = load_pickle(os.path.join(_feature_dir("jax"), name))
            got = load_pickle(os.path.join(_feature_dir("port"), name))
            np.testing.assert_allclose(got["text_features"],
                                       want["text_features"], **TOL)
            continue
        fj, lj = jax_load_cache(os.path.join(_feature_dir("jax"), name))
        ft, lt = load_feature_cache(os.path.join(_feature_dir("port"), name))
        assert ft.shape == fj.shape == (12, 3 if softmax else CFG.embed_dim)
        np.testing.assert_allclose(ft, fj, **TOL)
        np.testing.assert_array_equal(lt, lj)
    # the second call is a cache hit: no model is needed, nothing rewritten
    path = os.path.join(_feature_dir("port"), names[0])
    mtime = os.path.getmtime(path)
    ensure_features(cfg, None, None, splits=splits, list_T=list_T)
    assert os.path.getmtime(path) == mtime


def test_extract_to_caches_fetches_once(image_dataset, models):
    """The embeddings of a split come to the host in one transfer."""
    from transductive_clip_tpu_torch.ops.common import to_host

    _, port_model = models
    ds = build_dataset("eurosat", image_dataset)
    batches = iter_image_batches(ds.test, make_preprocess(32, "uint8"),
                                 batch_size=5)
    syncs = to_host.syncs
    emb, labels = extract_to_caches(port_model, batches,
                                    [(None, os.path.join("out", "visual.plk"))])
    assert to_host.syncs == syncs + 1
    assert emb.shape == (12, CFG.embed_dim) and labels.shape == (12,)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)


def test_missing_model_raises(image_dataset):
    with pytest.raises(ValueError, match="CLIP model"):
        ensure_features(_cfg(CfgNode, image_dataset, True), None, None)


def test_data_parallel_raises(image_dataset, bpe, models):
    """JAX's one-device rule: ``data_parallel`` in one process with no task
    group extracts on the single-device path, the caches equal to the
    ``data_parallel False`` ones."""
    for side, dp in (("single", False), ("dp", True)):
        ensure_features(_cfg(CfgNode, image_dataset, True, root=side,
                             data_parallel=dp),
                        models[1], make_preprocess(32, "uint8"))
    names = sorted(os.listdir(_feature_dir("single")))
    assert names == sorted(os.listdir(_feature_dir("dp"))) and names
    for name in names:
        want, got = (load_pickle(os.path.join(_feature_dir(side), name))
                     for side in ("single", "dp"))
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_data_layer_matches_jax(image_dataset):
    ds, dj = (build_dataset("eurosat", image_dataset),
              jax_build_dataset("eurosat", image_dataset))
    assert ds.classnames == dj.classnames and ds.template == dj.template
    assert [tuple(vars(d).values()) for d in ds.test] == [
        tuple(vars(d).values()) for d in dj.test]
    for (xt, yt), (xj, yj) in zip(
            iter_image_batches(ds.val, make_preprocess(24), batch_size=5),
            jax_iter_batches(dj.val, jax_preprocess(24), batch_size=5)):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


def test_tokenizer_ids_match_jax(bpe):
    prompts = ["a centered satellite photo of class 0.", "cat dog", "a cat",
               "  CAT  ", "café cat", "cat " * 50]
    tok, jtok = SimpleTokenizer(), JaxTokenizer()
    assert tok.encoder == jtok.encoder
    for p in prompts:
        assert tok.encode(p) == jtok.encode(p)
        np.testing.assert_array_equal(tok.encode_padded(p, 24),
                                      jtok.encode_padded(p, 24))


def test_zero_shot_evaluator_extracts_then_evaluates(image_dataset, bpe,
                                                     models):
    """Images on disk -> the port's towers -> the softmax cache -> the
    zero-shot evaluator, in one call (the evaluator used to raise without a
    cache)."""
    args = load_full_config(
        opts=["dataset", "eurosat", "method", "hard_em_dirichlet", "shots",
              "0", "number_tasks", "4", "batch_size", "2", "n_query", "6",
              "T", "30", "num_classes_test", "3", "k_eff_min", "2",
              "k_eff_max", "3", "iter", "3", "save_results", "False"],
        config_root=CONFIG_ROOT)
    args.dataset_path = image_dataset
    args.root = "data"
    acc, _ = EvaluatorZeroShot(device="cpu", args=args).run_full_evaluation(
        model=models[1], preprocess=make_preprocess(32, dtype="uint8"))
    assert 0.0 <= acc <= 1.0
    assert os.path.exists("data/eurosat/saved_features/"
                          "test_softmax_RN50_T30.plk")
    assert os.path.exists(text_cache_path(args))


@pytest.mark.parametrize("key,value,match", [
    ("clip_compute", "fp16", "clip_compute"),
    ("clip_attention", "cuda", "clip_attention"),
    ("clip_fold_bn", "maybe", "clip_fold_bn"),
    ("clip_fused_resnet", "sometimes", "clip_fused_resnet"),
])
def test_maybe_load_clip_rejects_what_jax_rejects(tmp_path, monkeypatch, key,
                                                  value, match):
    monkeypatch.chdir(tmp_path)
    opts = ["dataset", "eurosat", "method", "em_dirichlet", "shots", "0"]
    jax_args = jax_config(opts=opts, config_root=CONFIG_ROOT)
    args = load_full_config(opts=opts, config_root=CONFIG_ROOT)
    args[key] = jax_args[key] = value
    with pytest.raises(ValueError, match=match):
        jax_maybe_load_clip(jax_args)
    with pytest.raises(ValueError, match=match):
        cli.maybe_load_clip(args, device="cpu")


def test_maybe_load_clip_skips_the_model_with_caches(tmp_path, monkeypatch,
                                                     rng):
    """Every cache present: no model, so a missing checkpoint does not
    matter."""
    from transductive_clip_tpu_torch.features.cache import save_feature_cache

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(tmp_path / "none"))
    args = load_full_config(opts=["dataset", "eurosat", "shots", "0"],
                            config_root=CONFIG_ROOT)
    path = EvaluatorZeroShot(device="cpu", args=args).query_cache_path()
    save_feature_cache(path, rng.dirichlet(np.ones(10), 20).astype(
        np.float32), np.arange(20) % 10)
    assert cli.maybe_load_clip(args, device="cpu") == (None, None)
    os.remove(path)
    with pytest.raises(FileNotFoundError, match="No CLIP checkpoint"):
        cli.maybe_load_clip(args, device="cpu")

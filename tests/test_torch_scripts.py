"""The PyTorch port's script counterparts: scripts/run_synthetic_protocol_torch.py
(its --check gate, and --quick on the CPU), scripts/convert_feature_cache_torch.py
(plk <-> npz, the orbax error) and scripts/validate_checkpoint_torch.py on
random-weight OpenAI-layout checkpoints (tests/torch_clip.synth_state_dict),
as tests/test_config.py and tests/test_validate_checkpoint.py test the JAX
scripts."""

import contextlib
import dataclasses
import gzip
import io
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import convert_feature_cache_torch as cfc  # noqa: E402
import run_synthetic_protocol_torch as sp  # noqa: E402
import validate_checkpoint_torch as vc  # noqa: E402
from torch_clip import synth_state_dict  # noqa: E402

from transductive_clip_tpu_torch.models.clip import CLIP_CONFIGS  # noqa: E402
from transductive_clip_tpu_torch.models.clip.config import (  # noqa: E402
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)

torch.set_num_threads(2)

# tests/test_convert.py's tiny towers, as the port's configs
TINY_VIT = CLIPConfig(
    name="tiny-vit", embed_dim=16,
    vision=CLIPVisionConfig(image_size=32, patch_size=16, width=24, layers=2,
                            heads=4),
    text=CLIPTextConfig(vocab_size=64, context_length=8, width=16, layers=2,
                        heads=4))
TINY_RN = CLIPConfig(
    name="tiny-rn", embed_dim=16,
    vision=CLIPVisionConfig(image_size=32, width=8, heads=4, is_resnet=True,
                            resnet_layers=(1, 1, 1, 1)),
    text=CLIPTextConfig(vocab_size=64, context_length=8, width=16, layers=2,
                        heads=4))
# the text check tokenizes with the real tokenizer, whose ids index CLIP's
# whole vocabulary (torch's embedding raises on an id outside the table)
TINY_RN_TEXT = dataclasses.replace(
    TINY_RN, name="tiny-rn-text",
    text=dataclasses.replace(TINY_RN.text, vocab_size=49408))


def test_quick_check_bounds_are_the_jax_scripts():
    import run_synthetic_protocol as jax_sp

    assert sp.QUICK_CHECK_BOUNDS == jax_sp.QUICK_CHECK_BOUNDS


def test_synthetic_protocol_check_gate():
    """--check's logic: a full pass, an accuracy drop on any device, the
    latency ceiling on a CUDA device only, a missing method."""
    ok_rows = [(name, 1.0, 5.0) for name in sp.QUICK_CHECK_BOUNDS]
    assert sp.check_results(ok_rows, "cuda") == []
    assert sp.check_results(ok_rows, "cpu") == []

    bad = [("EM_DIRICHLET", 0.62, 5.0)] + [
        r for r in ok_rows if r[0] != "EM_DIRICHLET"]
    fails = sp.check_results(bad, "cpu")
    assert len(fails) == 1 and "EM_DIRICHLET" in fails[0]
    assert "0.620" in fails[0]

    slow = [("FS/PADDLE", 1.0, 99_000.0)] + [
        r for r in ok_rows if r[0] != "FS/PADDLE"]
    assert sp.check_results(slow, "cpu") == []
    fails = sp.check_results(slow, "cuda")
    assert len(fails) == 1 and "ceiling" in fails[0]

    fails = sp.check_results(ok_rows[1:], "cpu")
    assert fails == [f"{ok_rows[0][0]}: missing from results"]


def test_quick_protocol_runs_on_the_cpu():
    """``--quick --check --device cpu``: all 15 methods run, and every one
    passes its floor."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = sp.main(["--quick", "--check", "--device", "cpu"])
    assert len(rows) == len(sp.QUICK_CHECK_BOUNDS)
    assert "--check passed: 15 methods" in out.getvalue()
    assert sp.check_results(rows, "cpu") == []


def test_check_needs_quick():
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        sp.main(["--check", "--device", "cpu"])


@pytest.mark.parametrize("src,dst", [("plk", "npz"), ("npz", "plk")])
def test_convert_feature_cache_round_trip(tmp_path, src, dst):
    from transductive_clip_tpu_torch.features.store import open_store

    rng = np.random.default_rng(0)
    feats = rng.random((12, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 12)
    a, b, c = (str(tmp_path / f"cache{i}.{k}")
               for i, k in enumerate((src, dst, src)))
    open_store(src).save(a, feats, labels)
    with contextlib.redirect_stdout(io.StringIO()):
        cfc.main([a, b])
        cfc.main([b, c])
    for path, kind in ((b, dst), (c, src)):
        f, lab = open_store(kind).load(path)
        np.testing.assert_array_equal(f, feats)
        np.testing.assert_array_equal(lab, labels)


def test_convert_feature_cache_declines_orbax(tmp_path):
    from transductive_clip_tpu_torch.features.store import open_store

    src = str(tmp_path / "cache.npz")
    open_store("npz").save(src, np.zeros((2, 3), np.float32),
                           np.zeros(2, np.int64))
    with pytest.raises(NotImplementedError, match="orbax feature store is "
                                                  "declined"):
        cfc.main([src, str(tmp_path / "cache.orbax")])
    with pytest.raises(SystemExit, match="Unknown cache suffix"):
        cfc.main([src, str(tmp_path / "cache.bin")])


@pytest.fixture
def tiny_registered():
    """The tiny configs under CLIP_CONFIGS, for --backbone."""
    tiny = (TINY_RN, TINY_VIT, TINY_RN_TEXT)
    for cfg in tiny:
        CLIP_CONFIGS[cfg.name] = cfg
    yield
    for cfg in tiny:
        CLIP_CONFIGS.pop(cfg.name)


def _write_ckpt(tmp_path, cfg, sd=None):
    path = tmp_path / f"{cfg.name}.pt"
    torch.save(synth_state_dict(cfg) if sd is None else sd, str(path))
    return path


def _validate(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        vc.main(argv + ["--device", "cpu"])
    return e.value.code, buf.getvalue()


@pytest.mark.parametrize("cfg", [TINY_RN, TINY_VIT], ids=["rn", "vit"])
def test_validate_checkpoint_passes(tmp_path, tiny_registered, cfg):
    """A random-weight checkpoint passes the structure, forward, fold and
    oracle checks; a plain state dict skips the TorchScript oracle."""
    code, out = _validate([str(_write_ckpt(tmp_path, cfg)), "--backbone",
                           cfg.name])
    assert code == 0, out
    assert "RESULT: OK" in out
    for check in ("structure", "forward", "torch-reimpl"):
        assert f"[PASS] {check}" in out, out
    if cfg.vision.is_resnet:
        assert "[PASS] fold" in out
    assert "[skip] torchscript" in out


def test_validate_checkpoint_text_with_bpe(tmp_path, tiny_registered):
    src = os.path.join(REPO, "tests", "fixtures", "bpe_excerpt.txt")
    bpe = tmp_path / "bpe.txt.gz"
    with open(src, "rb") as f, gzip.open(bpe, "wb") as g:
        g.write(f.read())
    code, out = _validate([str(_write_ckpt(tmp_path, TINY_RN_TEXT)),
                           "--backbone", "tiny-rn-text", "--bpe", str(bpe)])
    assert code == 0, out
    assert "[PASS] text" in out


def test_validate_checkpoint_catches_faults(tmp_path, tiny_registered):
    """A transposed kernel fails the structure check; a kernel scaled by
    1.2 on its way into the towers (every shape right) fails against the
    independent oracle, which reads the checkpoint itself."""
    sd = synth_state_dict(TINY_RN)
    sd["visual.conv1.weight"] = sd["visual.conv1.weight"].permute(2, 3, 1, 0)
    code, out = _validate([str(_write_ckpt(tmp_path, TINY_RN, sd)),
                           "--backbone", "tiny-rn"])
    assert code == 1 and "[FAIL] structure" in out and "RESULT: FAIL" in out

    real = vc.TorchCLIP

    def scaled(cfg, sd, **kw):
        key = "visual.layer2.0.conv2.weight"
        return real(cfg, {**sd, key: sd[key] * 1.2}, **kw)

    vc.TorchCLIP = scaled
    try:
        code, out = _validate([str(_write_ckpt(tmp_path, TINY_RN)),
                               "--backbone", "tiny-rn"])
    finally:
        vc.TorchCLIP = real
    assert code == 1 and "[FAIL] torch-reimpl" in out, out


def test_validate_checkpoint_infers_the_backbone():
    sd = {"text_projection": np.zeros((512, 1024)),
          "visual.conv1.weight": np.zeros((32, 3, 3, 3)),
          "visual.attnpool.positional_embedding": np.zeros((50, 2048))}
    for stage, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            sd[f"visual.layer{stage}.{b}.conv1.weight"] = np.zeros(())
    assert vc.infer_backbone(sd) == "RN50"

"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU when no GPU is present, and
``chip_smoke.py`` fails without a GPU or without the rest of the repo."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import style_seqcvae_tpu_torch
from style_seqcvae_tpu_torch.config import Config
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig, init_captioner
from style_seqcvae_tpu_torch.models.detector.extract import extract_device_features
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig, init_detector
from style_seqcvae_tpu_torch.scripts import train as train_cli
from style_seqcvae_tpu_torch.training.trainer import create_train_state, make_train_step
from style_seqcvae_tpu_torch.weights import from_jax_detector_params, from_jax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(style_seqcvae_tpu_torch.__path__,
                                                        "style_seqcvae_tpu_torch."))


def _run(code_or_args, cwd, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ([sys.executable, "-c", code_or_args] if isinstance(code_or_args, str)
            else [sys.executable, *code_or_args])
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_no_jax():
    modules = _port_modules()
    for name in ("ops.kernels.vocab_topk_lse", "ops.kernels.topk_lse",
                 "ops.kernels.roi_align", "ops.kernels.nms", "ops.roi_align", "ops.nms",
                 "ops.boxes", "models.detector.anchors", "models.detector.defaults",
                 "models.detector.resnet", "models.detector.rpn",
                 "models.detector.faster_rcnn", "models.detector.extract",
                 "decoding.beam_search", "decoding.cbs", "decoding.fsm", "decoding.select",
                 "decoding.samplers", "evaluation.metrics", "config", "data.tokenizer",
                 "data.vocabulary", "data.config_attrib_selection", "data.readers",
                 "data.latents", "data.datasets", "data.prefetch", "decoding.constraint_filter",
                 "utils.features_io", "scripts.inference", "scripts.train",
                 "training.optimizer", "training.trainer", "training.checkpointing",
                 "utils.logging", "utils.torch_import", "models.baseline", "evaluation.eval",
                 "scripts.eval", "data.image_decode", "data.detection", "decoding.device_fsm",
                 "serving", "scripts.extract_features", "scripts.serve", "scripts.load_test",
                 "ops.roi_crop", "models.detector.vgg",
                 "models.detector.targets", "training.detector_optimizer",
                 "evaluation.detection_eval", "scripts.train_detector",
                 "scripts.eval_detections", "parallel.multihost", "parallel.mesh",
                 "parallel.collectives", "parallel.distributed_worker",
                 "parallel.tensor_parallel", "preprocessing", "data.image_encode",
                 "scripts.preprocess", "scripts.build_vocabulary",
                 "scripts.make_synthetic_corpus", "scripts.make_world",
                 "scripts.eval_baselines", "scripts.style_report", "scripts.three_stage"):
        assert "style_seqcvae_tpu_torch." + name in modules
    code = "\n".join([
        "import sys",
        # a None entry makes any import of these names raise ImportError
        "sys.modules['jax'] = None",
        "sys.modules['style_seqcvae_tpu'] = None",
        "sys.modules['yaml'] = None",
        "sys.modules['h5py'] = None",
        "sys.modules['PIL'] = None",
        "import importlib",
        f"for name in {modules!r}: importlib.import_module(name)",
        "import chip_smoke",
        "assert not any(m in ('jax', 'PIL') or m.startswith(('jax.', 'PIL.', "
        "'style_seqcvae_tpu.')) for m, v in sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    res = _run(code, ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = CaptionerConfig(vocab_size=10, image_feature_size=4, embedding_size=300,
                          hidden_size=4, attention_projection_size=4, z_space=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_captioner(cfg)
    params = init_captioner(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeHarness(params, cfg)
    feats = np.zeros((1, 3, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeHarness(params, cfg).decode_beam(feats, None, None, torch.Generator(), 1)
    seqs, lp = DecodeHarness(params, cfg, device="cpu").decode_beam(
        feats, None, None, torch.Generator().manual_seed(0), 1)
    assert seqs.device.type == lp.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeHarness(params, cfg).decode_sample(feats, None, None, torch.Generator(), 1,
                                                 "multinomial")
    toks = DecodeHarness(params, cfg, device="cpu").decode_sample(
        feats, None, None, torch.Generator().manual_seed(0), 1, "multinomial")
    assert toks.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"embedding": params["embedding"].numpy()})

    # training: the state, and so every train step, is on the GPU unless
    # the caller asks for the CPU; the train CLI likewise without --cpu
    config = Config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(params, config, cfg, seed=0)
    state = create_train_state(params, config, cfg, seed=0, device="cpu")
    batch = {"image_features": np.ones((2, 3, 4), np.float32),
             "caption_tokens": np.full((2, 3), 2, np.int32),
             "sentiment": np.ones((2, 1), np.float32)}
    state, metrics = make_train_step(cfg, 750.0)(state, batch)
    assert metrics["loss"].device.type == "cpu" and state.step == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", str(ROOT / "configs" / "style_seqcvae_senticap.yml"),
                        "--serialization-dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_baseline_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from style_seqcvae_tpu_torch.models.baseline import init_baseline
    from style_seqcvae_tpu_torch.scripts import inference as inference_cli
    from style_seqcvae_tpu_torch.training.trainer import make_baseline_train_step

    cfg = CaptionerConfig(vocab_size=10, image_feature_size=4, embedding_size=300,
                          hidden_size=4, attention_projection_size=4, z_space=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_baseline(cfg)
    params = init_baseline(cfg, device="cpu")
    feats = np.zeros((1, 3, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeHarness(params, cfg, family="baseline")
    seqs, _ = DecodeHarness(params, cfg, device="cpu", family="baseline").decode_beam(
        feats, None, None, torch.Generator().manual_seed(0), 1)
    assert seqs.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(params, Config(), cfg, seed=0)
    state = create_train_state(params, Config(), cfg, seed=0, device="cpu")
    batch = {"image_features": np.ones((2, 3, 4), np.float32),
             "caption_tokens": np.full((2, 3), 2, np.int32)}
    state, metrics = make_baseline_train_step(cfg)(state, batch)
    assert metrics["loss"].device.type == "cpu" and state.step == 1
    config = str(ROOT / "configs" / "style_seqcvae_senticap.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", config, "--model", "baseline",
                        "--serialization-dir", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_cli.main(["--config", config, "--model", "baseline",
                            "--output-path", str(tmp_path / "p.json")])


def test_detector_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = DetectorConfig(num_classes=3, num_att_classes=0, depth=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_detector(cfg)
    params = init_detector(cfg, device="cpu")
    images = np.zeros((1, 32, 32, 3), np.float32)
    im_info = np.array([[32.0, 32.0, 1.0]], np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_device_features(params, cfg, images, im_info)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_detector_params({"resnet": {"conv1": np.zeros((7, 7, 3, 64), np.float32)}})


def test_image_and_serving_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from style_seqcvae_tpu_torch.data.detection import decode_image_bgr, load_image_bgr
    from style_seqcvae_tpu_torch.decoding.device_fsm import AttributeWordformTable
    from style_seqcvae_tpu_torch.scripts import extract_features as extract_cli
    from style_seqcvae_tpu_torch.scripts import serve as serve_cli
    from style_seqcvae_tpu_torch.serving import make_serve_fn

    ppm = b"P6 1 1 255\n\x00\x00\x00"
    (tmp_path / "a.ppm").write_bytes(ppm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_image_bgr(ppm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_image_bgr(str(tmp_path / "a.ppm"))
    assert decode_image_bgr(ppm, "cpu").device.type == "cpu"
    table = AttributeWordformTable(*(np.zeros((1, 5), np.int32), np.zeros((1, 5), bool),
                                     np.zeros((1,), bool), np.zeros((1,), np.int32)))
    cap_cfg = CaptionerConfig(vocab_size=10, embedding_size=300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serve_fn(DetectorConfig(), cap_cfg, table)
    (tmp_path / "inst.json").write_text('{"images": [], "annotations": [], "categories": []}')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_cli.main(["--instances-json", str(tmp_path / "inst.json"),
                          "--output", str(tmp_path / "f.h5")])
    assert not (tmp_path / "f.h5").exists()
    config = str(ROOT / "configs" / "style_seqcvae_senticap.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--config", config, "--image", str(tmp_path / "a.ppm")])


def test_chip_smoke_fails_without_gpu():
    res = _run(["chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout

"""The port's world generator, its reports and its three-stage workflow
against the JAX package's scripts, on the CPU.

* ``make_world`` at the JAX test's own size (``tests/test_make_world.py``:
  40 / 6 / 6 images, 12 Senticap train images, seed 3), both scripts run
  as subprocesses side by side: ``render_image`` bit-equal scene by scene,
  every JSON, pickle, TSV and vocabulary file byte-equal (the instances
  files once ``.jpg`` reads ``.png``: the port writes PNG on the host,
  ``--image-format png``), and each PNG decodes to exactly the rendered
  pixels. JPEG (the default) needs the card: without one it raises and
  writes nothing.
* ``eval_baselines`` and ``style_report`` on that world, with features
  written by ``FeaturesWriter`` and prediction files built here: the same
  JSON as the JAX scripts' (floats within 1e-12: JAX's ROUGE may batch its
  LCS through the native library, the port's is pure Python).
* ``three_stage``: the argv of every CLI it starts equals, flag for flag,
  what ``scripts/three_stage.sh`` runs (recorded with a stand-in
  ``python`` on ``PATH``), with its two inline Python blocks in the same
  places; ``captioner_config.yml`` is the heredoc's text and reads back
  through the port's ``Config`` as JAX's ``Config`` reads it; the mAP gate
  and the constraint boxes do what the inline blocks do; then one run of
  stages 3 to 5 with ``--cpu`` at 2 captioner steps.
"""

import importlib.util
import json
import os
import re
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from style_seqcvae_tpu.config import Config as JConfig
from style_seqcvae_tpu_torch.config import Config as TConfig
from style_seqcvae_tpu_torch.data.image_decode import decode_png
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig, init_detector
from style_seqcvae_tpu_torch.scripts import eval_baselines as t_baselines
from style_seqcvae_tpu_torch.scripts import extract_features as t_extract
from style_seqcvae_tpu_torch.scripts import make_world as t_world
from style_seqcvae_tpu_torch.scripts import style_report as t_style
from style_seqcvae_tpu_torch.scripts import three_stage as t_three
from style_seqcvae_tpu_torch.utils.features_io import FeaturesWriter, pack_obj_atts
from style_seqcvae_tpu_torch.weights import save_params_npz, to_jax_detector_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD_ARGS = ["--num-train", "40", "--num-val", "6", "--num-test", "6",
              "--senticap-train", "12", "--seed", "3"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d: Path):
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """JAX's world (PIL JPEGs) and the port's (PNG), made side by side."""
    d = tmp_path_factory.mktemp("worlds")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "scripts/make_world.py", "--out-dir",
                               str(d / "jax"), *WORLD_ARGS], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable, "-m", "style_seqcvae_tpu_torch.scripts.make_world",
                               "--out-dir", str(d / "port"), "--image-format", "png",
                               *WORLD_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-1500:]
    assert outs[0][0] == outs[1][0].replace(str(d / "port"), str(d / "jax"))
    return d / "jax", d / "port"


def test_render_image_bit_equal_to_jax():
    jw = _jax_script("make_world")
    for seed in range(3):
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(2):
            scene = t_world.sample_scene(rt, 192, 256)
            assert scene == jw.sample_scene(rj, 192, 256)
            (img_t, boxes_t), (img_j, boxes_j) = (t_world.render_image(rt, 192, 256, scene),
                                                  jw.render_image(rj, 192, 256, scene))
            np.testing.assert_array_equal(img_t, img_j)
            assert boxes_t == boxes_j


def test_world_files_equal_jax(worlds):
    jd, td = worlds
    jf, tf = _files(jd), _files(td)
    j_images = sorted(k for k in jf if k.startswith("images/"))
    assert sorted(k for k in tf if k.startswith("images/")) == \
        [k[:-len("jpg")] + "png" for k in j_images]
    assert len(j_images) == 52
    rest = [k for k in jf if not k.startswith("images/")]
    assert sorted(rest) == sorted(k for k in tf if not k.startswith("images/"))
    assert {"world.json", "sentiglove10.pkl", "wordforms_senti.tsv", "vocabulary/tokens.txt",
            "attribs/attrib2string.pkl", "senticap_dataset.json"} <= set(rest)
    for k in rest:
        want = jf[k]
        if k.startswith("instances_"):
            want = want.replace(b".jpg", b".png")
        assert tf[k] == want, k


def test_png_images_decode_to_the_rendered_pixels(worlds):
    _, td = worlds
    rng = np.random.RandomState(3)            # main's stream: the train split first
    images = json.loads((td / "instances_train.json").read_text())["images"]
    for im in images[:4]:
        scene = t_world.sample_scene(rng, 384, 512)
        img, _ = t_world.render_image(rng, 384, 512, scene)
        np.testing.assert_array_equal(decode_png((td / "images" / im["file_name"]).read_bytes()),
                                      img)


def test_jpeg_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_world.main(["--out-dir", str(tmp_path / "w"), "--num-train", "2"])
    assert not (tmp_path / "w").exists()


def test_extract_cli_reads_a_named_training_checkpoint(worlds, tmp_path):
    """The workflow's ``--checkpoint-path DIR --checkpoint-name NAME`` (the
    JAX CLI's flags) reads the port's detector training checkpoint
    DIR/NAME/state.npz, as ``--checkpoint-path DIR/NAME`` does."""
    _, td = worlds
    world = json.loads((td / "instances_val.json").read_text())
    det_cfg = DetectorConfig(num_classes=len(world["categories"]) + 1, num_att_classes=0,
                             depth=50)
    params = init_detector(det_cfg, seed=4, device="cpu")
    ckpt = tmp_path / "detector" / "detector_epoch_1"
    ckpt.mkdir(parents=True)
    save_params_npz({"params": to_jax_detector_params(params)}, str(ckpt / "state.npz"))
    # a small canvas and few proposals: the plain NMS is slow on the CPU
    common = ["--instances-json", str(td / "instances_val.json"), "--image-root",
              str(td / "images"), "--depth", "50", "--canvas", "96", "128", "--max-images",
              "1", "--thresh", "0.0", "--cpu", "--config-override", "DET.TEST.SCALES", "[96]",
              "DET.TEST.MAX_SIZE", "128", "DET.TEST.RPN_PRE_NMS_TOP_N", "64",
              "DET.TEST.RPN_POST_NMS_TOP_N", "16"]
    outs = []
    for name, ckpt_args in (("named", ["--checkpoint-path", str(tmp_path / "detector"),
                                       "--checkpoint-name", "detector_epoch_1"]),
                            ("path", ["--checkpoint-path", str(ckpt)])):
        out = tmp_path / f"{name}.h5"
        assert t_extract.main([*common, *ckpt_args, "--output", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    with pytest.raises(SystemExit):                  # not a checkpoint of the port's
        t_extract.main([*common, "--checkpoint-path", str(tmp_path / "detector"),
                        "--checkpoint-name", "detector_epoch_2", "--output",
                        str(tmp_path / "x.h5")])


def _features_and_preds(world: Path, run: Path):
    """features_{train,test}.h5 by FeaturesWriter (seeded), the detector's
    test detections, and the four decodes' prediction files."""
    run.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(11)
    caps = json.loads((world / "captions_train.json").read_text())["annotations"]
    dets = []
    for split in ("train", "test"):
        inst = json.loads((world / f"instances_{split}.json").read_text())
        ids = [im["id"] for im in inst["images"]]
        writer = FeaturesWriter(str(run / f"features_{split}.h5"), len(ids))
        for i, iid in enumerate(ids):
            anns = [a for a in inst["annotations"] if a["image_id"] == iid]
            cls = [anns[j % len(anns)]["category_id"] for j in range(24)]
            writer.write(i, iid, rng.randn(24, 2048).astype(np.float32),
                         pack_obj_atts(cls, [[] for _ in cls]), np.zeros((0,), np.float32))
            if split == "test":
                dets += [{"image_id": iid, "category_id": a["category_id"], "bbox": a["bbox"],
                          "score": 0.9} for a in anns]
        writer.close()
    (run / "detections_test.json").write_text(json.dumps(dets))
    w = json.loads((world / "world.json").read_text())
    test_ids = [im["id"] for im in json.loads(
        (world / "instances_test.json").read_text())["images"]]
    for name, words in (("neutral", []), ("pos", w["pos_words"]), ("neg", w["neg_words"]),
                        ("cbs_pos", w["pos_words"])):
        preds = []
        for iid in test_ids:
            for _ in range(5):
                c = caps[rng.randint(len(caps))]["caption"]
                if words and rng.rand() < 0.7:
                    c = f"{c} {words[rng.randint(len(words))]}"
                preds.append({"image_id": iid, "caption": c})
        (run / f"preds_{name}.json").write_text(json.dumps(preds))


def _assert_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-12, (path, got, want)
    else:
        assert got == want, path


@pytest.mark.parametrize("script", ["eval_baselines", "style_report"])
def test_reports_match_jax(worlds, tmp_path, monkeypatch, script):
    _, td = worlds
    run = tmp_path / "run"
    _features_and_preds(td, run)
    args = ["--world", str(td), "--run", str(run)]
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *args, "--output", str(tmp_path / "j.json")])
    _jax_script(script).main()
    port = t_baselines if script == "eval_baselines" else t_style
    assert port.main([*args, "--output", str(tmp_path / "t.json")]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    _assert_close(json.loads((tmp_path / "t.json").read_text()), want)
    if script == "eval_baselines":
        assert set(want) == {"model", "random", "retrieval"}
    else:
        assert set(want["runs"]) == {"pos", "neg", "neutral", "cbs_pos"} and "control" in want


def _shell_workflow(tmp_path, world, run, cap_iters, det_epochs):
    """Run ``scripts/three_stage.sh`` with a stand-in ``python`` that records
    its argv and does nothing: the CLI commands, and ``-`` for each inline
    Python block with its arguments."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "python"
    fake.write_text('#!/bin/sh\nprintf \'%s\\0\' "$@" >> "$FAKE_LOG"; printf \'\\n\' >> '
                    '"$FAKE_LOG"\nif [ "$1" = "-" ]; then cat > /dev/null; fi\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "argv.log"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               FAKE_LOG=str(log), W=world, RUN=run, CAP_ITERS=str(cap_iters),
               DET_EPOCHS=str(det_epochs))
    subprocess.run(["bash", "scripts/three_stage.sh"], cwd=ROOT, env=env, check=True,
                   stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, timeout=120)
    return [line.rstrip("\0").split("\0") for line in log.read_text().split("\n") if line]


def test_stages_and_argv_match_the_shell_script(tmp_path):
    world, run = "/data/world", str(tmp_path / "run")
    recorded = _shell_workflow(tmp_path, world, run, cap_iters=7, det_epochs=3)
    a = t_three.parser.parse_args(["--world", world, "--run", run, "--cap-iters", "7",
                                   "--det-epochs", "3"])
    # every step but the config's, which the script writes with cat
    planned = [what for stage in t_three.STAGES for name, what in t_three.stage_steps(stage, a)
               if name != "stage3_config"]
    assert len(planned) == len(recorded) == 17
    for what, sh in zip(planned, recorded):
        if callable(what):
            assert sh[0] == "-"                    # an inline Python block of the script
            continue
        argv = t_three.cli_argv(what, cpu=False)
        assert argv[1:3] == ["-m", f"style_seqcvae_tpu_torch.scripts.{what[0]}"]
        assert sh[0] == f"scripts/{what[0]}.py" and argv[3:] == sh[1:], what[0]
    cpu = t_three.cli_argv(t_three.stage_steps("3", a)[1][1], cpu=True)
    assert cpu[-1] == "--cpu"
    assert "--cpu" not in t_three.cli_argv(t_three.stage_steps("5", a)[0][1], cpu=True)
    # the heredoc's config, as the script wrote it
    sh_cfg = Path(run, "captioner_config.yml").read_text()
    assert t_three.captioner_config(world, run, 7) == sh_cfg
    port_path = tmp_path / "port.yml"
    port_path.write_text(t_three.captioner_config(world, run, 7))
    want = JConfig(run + "/captioner_config.yml")._C.to_dict()
    assert TConfig(str(port_path))._C.to_dict() == want


def _inline_block(marker: str) -> str:
    """The shell script's inline Python block that follows ``marker``."""
    text = (ROOT / "scripts" / "three_stage.sh").read_text()
    start = text.index("<<'EOF'\n", text.index(marker)) + len("<<'EOF'\n")
    return text[start:text.index("\nEOF\n", start)]


@pytest.mark.parametrize("ap50", [0.62, 0.31])
def test_map_gate_and_constraint_boxes_match_the_shell_blocks(tmp_path, ap50):
    m = tmp_path / "detection_map.json"
    m.write_text(json.dumps({"AP50": ap50, "mAP": 0.2}))
    sh = subprocess.run([sys.executable, "-", str(m), "0.5"],
                        input=_inline_block('"$RUN/detection_map.json" "$MAP_GATE"'),
                        capture_output=True, text=True)
    assert (t_three.map_gate(str(m), 0.5) == 0) == (sh.returncode == 0) == (ap50 >= 0.5)
    world, j, t = tmp_path / "w", tmp_path / "j", tmp_path / "t"
    for d in (world, j, t):
        d.mkdir()
    (world / "instances_test.json").write_text(json.dumps(
        {"images": [], "annotations": [], "categories": [{"id": 1, "name": "ring"}]}))
    dets = json.dumps([{"image_id": 3, "category_id": 1, "bbox": [1.5, 2, 3, 4], "score": 0.5}])
    for d in (j, t):
        (d / "detections_test.json").write_text(dets)
    subprocess.run([sys.executable, "-", str(j), str(world)], check=True, capture_output=True,
                   input=_inline_block('"$RUN" "$W"'), text=True)
    assert t_three.constraint_boxes(str(t), str(world)) == 0
    assert (t / "constraint_boxes_test.json").read_bytes() == \
        (j / "constraint_boxes_test.json").read_bytes()


def test_three_stage_cpu_run_stages_3_to_5(worlds, tmp_path, capsys, monkeypatch):
    """Stages 3 to 5 on the port's PNG world with seeded features, two
    captioner steps, every CLI with --cpu."""
    # the CLIs' processes without nltk, as on the card's machine (an import
    # of nltk takes seconds here, in each of the run's 11 processes)
    stub = tmp_path / "no_nltk"
    stub.mkdir()
    (stub / "nltk.py").write_text("raise ImportError('nltk is blocked')\n")
    monkeypatch.setenv("PYTHONPATH", str(stub))
    _, td = worlds
    run = tmp_path / "run"
    _features_and_preds(td, run)
    for name in ("neutral", "pos", "neg", "cbs_pos"):
        (run / f"preds_{name}.json").unlink()
    rc = t_three.main(["3", "4", "5", "--world", str(td), "--run", str(run),
                       "--cap-iters", "2", "--cpu"])
    assert rc == 0, capsys.readouterr().out[-3000:]
    stats = json.loads((run / "three_stage.json").read_text())
    assert list(stats["stages"]) == ["3", "4", "5"]
    for stage in stats["stages"].values():
        assert stage["rc"] == 0 and not any(stage["launches"].values())
    assert (run / "captioner" / "checkpoint_2").is_dir()
    for name in ("neutral", "pos", "neg", "cbs_pos"):
        preds = json.loads((run / f"preds_{name}.json").read_text())
        assert len(preds) == 6 * 20 and all(re.fullmatch(r"[a-z ]*", p["caption"])
                                            for p in preds)
    report = json.loads((run / "style_report.json").read_text())
    assert set(report["runs"]) == {"pos", "neg", "neutral", "cbs_pos"}
    assert set(json.loads((run / "eval_baselines.json").read_text())) == \
        {"model", "random", "retrieval"}
    with open(run / "captioner_config.yml") as f:
        assert f.read() == t_three.captioner_config(str(td), str(run), 2)


def test_record_inputs_saves_each_kernels_first_call(tmp_path, monkeypatch):
    """Under SSC_KERNEL_INPUTS a kernel's first launch in a process saves
    its arguments (tensors on the CPU), later launches nothing; unset, it
    writes nothing. The workflow gives each step's process its own
    directory."""
    from style_seqcvae_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "_recorded", set())
    monkeypatch.delenv(kernels.KERNEL_INPUTS_ENV, raising=False)
    kernels.record_inputs("nms", boxes=torch.zeros(1, 2, 4))
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv(kernels.KERNEL_INPUTS_ENV, str(tmp_path / "step"))
    boxes = torch.arange(8.0).reshape(1, 2, 4)
    kernels.record_inputs("nms", boxes=boxes, threshold=0.7, presorted=True)
    kernels.record_inputs("nms", boxes=boxes + 1, threshold=0.3, presorted=False)
    saved = torch.load(tmp_path / "step" / "nms.pt")
    assert torch.equal(saved["boxes"], boxes)
    assert (saved["threshold"], saved["presorted"]) == (0.7, True)
    assert [p.name for p in (tmp_path / "step").iterdir()] == ["nms.pt"]
    monkeypatch.setenv(kernels.KERNEL_INPUTS_ENV, "/parent")
    got = {}
    monkeypatch.setattr(t_three.subprocess, "Popen", lambda argv, env, **kw: got.update(env) or (
        _ for _ in ()).throw(RuntimeError("stop")))
    with pytest.raises(RuntimeError, match="stop"):
        t_three.run_cli(["true"], tmp_path / "log", tmp_path / "report.json", "stage1_detector")
    assert got[kernels.KERNEL_INPUTS_ENV] == os.path.join("/parent", "stage1_detector")

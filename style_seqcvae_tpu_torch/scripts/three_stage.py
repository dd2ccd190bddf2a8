"""The three-stage workflow on a ``make_world`` world (counterpart of the
repository's ``scripts/three_stage.sh``), through the port's CLIs:

    stage 1  train_detector     the detector from scratch (bf16 compute)
    gate     extract_features + eval_detections on the val split; AP50 must
             reach --map-gate
    2        extract_features   features_{train,test}.h5 and the detections
             from the trained checkpoint
    3        captioner_config.yml, then train (mode 1 Style-SeqCVAE) on the
             extracted features
    4        inference          pos / neg / neutral decodes, then a CBS leg
             constrained by the detector's own test detections
    5        eval (three times), eval_baselines, style_report

    python -m style_seqcvae_tpu_torch.scripts.three_stage [STAGE ...] \\
        [--world W] [--run RUN] [--det-epochs 16] [--det-depth 50] \\
        [--det-lr 0.004] [--det-lr-decay-epochs 12] [--cap-iters 20000] \\
        [--map-gate 0.5] [--cpu]

The stages default to ``1 gate 2 3 4 5``. Each knob's default comes from
the shell script's environment variable (``W``, ``RUN``, ``DET_EPOCHS``,
``DET_DEPTH``, ``DET_LR``, ``DET_LR_DECAY_EPOCHS``, ``CAP_ITERS``,
``MAP_GATE``), then from the script's own default, except ``RUN``, which
defaults to ``runs/pipeline3_torch`` so that the JAX run's committed
artifacts in ``runs/pipeline3`` stay as they are. Relative paths are
taken from the repository's root, as the shell script ``cd``\\ s there.
Every CLI runs as ``python -m style_seqcvae_tpu_torch.scripts.<cli>`` in a
subprocess with the shell script's flags (plus ``--cpu`` under ``--cpu``),
its output copied to the stage's log in ``RUN``; a non-zero exit ends the
run with that code. The shell script's two inline Python blocks, the mAP
gate and the conversion of the detections into constraint boxes, run in
this process.

Each CLI process writes its kernel launches (``ops/kernels::
report_launches``), and ``RUN/three_stage.json`` records every stage's exit
code, seconds and launches, and every command's argv. When
``SSC_KERNEL_INPUTS`` names a directory, each CLI process saves every
kernel's inputs at its first launch under ``DIR/<step>/``
(``ops/kernels::record_inputs``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from style_seqcvae_tpu_torch.ops.kernels import KERNEL_INPUTS_ENV, LAUNCH_REPORT_ENV

ROOT = Path(__file__).resolve().parents[2]
STAGES = ("1", "gate", "2", "3", "4", "5")
DET_OVERRIDES = ["DET.TRAIN.SCALES", "[384]", "DET.TRAIN.MAX_SIZE", "512",
                 "DET.TEST.SCALES", "[384]", "DET.TEST.MAX_SIZE", "512",
                 "DET.TRAIN.CLIP_GRADIENTS", "10.0"]

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("stages", nargs="*", default=list(STAGES), metavar="STAGE",
                    help="any of 1 gate 2 3 4 5 (default: all); they run in that order")
parser.add_argument("--world", default=os.environ.get("W", "worlds/quality"))
parser.add_argument("--run", default=os.environ.get("RUN", "runs/pipeline3_torch"))
parser.add_argument("--det-epochs", type=int, default=int(os.environ.get("DET_EPOCHS", 16)))
parser.add_argument("--det-depth", type=int, default=int(os.environ.get("DET_DEPTH", 50)))
parser.add_argument("--det-lr", default=os.environ.get("DET_LR", "0.004"))
parser.add_argument("--det-lr-decay-epochs", type=int,
                    default=int(os.environ.get("DET_LR_DECAY_EPOCHS", 12)))
parser.add_argument("--cap-iters", type=int, default=int(os.environ.get("CAP_ITERS", 20000)))
parser.add_argument("--map-gate", type=float, default=float(os.environ.get("MAP_GATE", 0.5)))
parser.add_argument("--cpu", action="store_true",
                    help="run every CLI on the CPU (the kernels' plain versions)")

CAPTIONER_CONFIG = """RANDOM_SEED: 42
PRINT_EVERY_N_BATCHES: 100
DATA:
  VOCABULARY: {W}/vocabulary
  TRAIN_FEATURES: {RUN}/features_train.h5
  INFER_FEATURES: {RUN}/features_test.h5
  TRAIN_CAPTIONS: {W}/captions_train.json
  INFER_CAPTIONS: {W}/captions_test.json
  SENTICAP_CAPTIONS: {W}/senticap_dataset.json
  DO_LOAD_COCO: true
  DO_LOAD_SENTICAP: true
  MAX_CAPTION_LENGTH: 20
  MAX_BOXES: 24
  CBS:
    INFER_BOXES: {RUN}/detections_test.json
    CLASS_HIERARCHY: {W}/class_hierarchy.json
    WORDFORMS: {W}/wordforms_objects.tsv
    WORDFORMS_ATTRIBS: {W}/wordforms_attribs.tsv
    MAX_GIVEN_OBJECTS: 2
    MAX_GIVEN_CONSTRAINTS: 3
MODEL:
  IMAGE_FEATURE_SIZE: 2048
  EMBEDDING_SIZE: 600
  HIDDEN_SIZE: 900
  ATTENTION_PROJECTION_SIZE: 768
  BEAM_SIZE: 5
  USE_CBS: false
  CBS_SIMPLE: true
  MIN_CONSTRAINTS_TO_SATISFY: 2
  Z_SPACE: 150
  KLD_WEIGHT: 750
  SENTIMENT_VAE: 1
  SENTI_PRIOR_MULTIP: 0.5
  SIMPLE_VAE: false
  PRIOR_STD: 1.0
  N_Z_SAMPLES: 20
  STATE_MACHINE_PER_Z_SAMPLE: true
OPTIM:
  BATCH_SIZE: 150
  NUM_ITERATIONS: {CAP_ITERS}
  LR: 0.015
  # the reference's two-phase decoder-freeze schedule (decoder updates
  # every 30th step until iteration EPOCH_START_DECODER_TRAINING) is
  # implemented + tested (test_training.py) and was exercised by the
  # r4 70k run; on THIS small-vocab world it let an encoder collapse at
  # ~5k steps go unrecovered (reconstr 37 -> 230 with the decoder
  # frozen), so the pipeline trains both phases jointly
  EPOCH_START_DECODER_TRAINING: 0
  BEFORE_UPDATE_DECODER_EVERY: 30
"""


def captioner_config(world: str, run: str, cap_iters: int) -> str:
    """The text of ``captioner_config.yml``, the shell script's heredoc."""
    return CAPTIONER_CONFIG.format(W=world, RUN=run, CAP_ITERS=cap_iters)


def map_gate(detection_map: str, gate: float) -> int:
    """The mAP gate: 0 when the val split's AP50 reaches ``gate``, else 1."""
    with open(detection_map) as f:
        m = json.load(f)
    if m["AP50"] < gate:
        print(f"mAP gate FAILED: AP50={m['AP50']:.3f} < {gate}", flush=True)
        return 1
    print(f"mAP gate PASSED: AP50={m['AP50']:.3f} mAP={m['mAP']:.3f} >= {gate}", flush=True)
    return 0


def constraint_boxes(run: str, world: str) -> int:
    """The detector's test detections (a COCO results list) as the
    constraint-box reader's {annotations, categories}."""
    with open(f"{run}/detections_test.json") as f:
        dets = json.load(f)
    with open(f"{world}/instances_test.json") as f:
        cats = json.load(f)["categories"]
    with open(f"{run}/constraint_boxes_test.json", "w") as f:
        json.dump({"annotations": dets, "categories": cats}, f)
    print(f"constraint boxes: {len(dets)} detections", flush=True)
    return 0


# a step of a stage: (log name, CLI module and its argv) or (log name, function)
Step = Tuple[str, Union[List[str], Callable[[], int]]]


def stage_steps(stage: str, a: argparse.Namespace) -> List[Step]:
    """The steps of ``stage`` in order, with the shell script's flags."""
    W, RUN, E = a.world, a.run, str(a.det_epochs)
    ckpt = ["--checkpoint-path", f"{RUN}/detector", "--checkpoint-name", f"detector_epoch_{E}"]
    if stage == "1":
        return [("stage1_detector", [
            "train_detector", "--instances-json", f"{W}/instances_train.json",
            "--image-root", f"{W}/images", "--senticap-json", f"{W}/senticap_dataset.json",
            "--attribs-dir", f"{W}/attribs", "--serialization-dir", f"{RUN}/detector",
            "--epochs", E, "--depth", str(a.det_depth),
            "--lr-decay-epochs", str(a.det_lr_decay_epochs), "--unfreeze-backbone",
            "--ims-per-batch", "8", "--steps-per-dispatch", "4", "--bf16-compute",
            "--canvas", "384", "512", "--config-override", "DET.TRAIN.LEARNING_RATE",
            str(a.det_lr), *DET_OVERRIDES])]
    if stage == "gate":
        return [("gate_extract_val", [
            "extract_features", "--instances-json", f"{W}/instances_val.json",
            "--image-root", f"{W}/images", "--attribs-dir", f"{W}/attribs", *ckpt,
            "--output", f"{RUN}/features_val.h5",
            "--detections-output", f"{RUN}/detections_val.json",
            "--depth", str(a.det_depth), "--canvas", "384", "512", "--batch-size", "16",
            "--thresh", "0.05", "--config-override", *DET_OVERRIDES]),
            ("gate_map", [
                "eval_detections", "--detections", f"{RUN}/detections_val.json",
                "--instances-json", f"{W}/instances_val.json",
                "--output", f"{RUN}/detection_map.json"]),
            ("gate_check", lambda: map_gate(f"{RUN}/detection_map.json", a.map_gate))]
    if stage == "2":
        return [(f"stage2_extract_{split}", [
            "extract_features", "--instances-json", f"{W}/instances_{split}.json",
            "--image-root", f"{W}/images", "--attribs-dir", f"{W}/attribs", *ckpt,
            "--output", f"{RUN}/features_{split}.h5",
            "--detections-output", f"{RUN}/detections_{split}.json",
            "--depth", str(a.det_depth), "--canvas", "384", "512", "--batch-size", "16",
            "--thresh", "0.5", "--config-override", *DET_OVERRIDES])
            for split in ("train", "test")]
    cfg = f"{RUN}/captioner_config.yml"
    if stage == "3":
        def write_config() -> int:
            Path(cfg).write_text(captioner_config(W, RUN, a.cap_iters))
            return 0

        return [("stage3_config", write_config),
                ("stage3_train", [
                    "train", "--config", cfg, "--serialization-dir", f"{RUN}/captioner",
                    "--checkpoint-every", "5000", "--steps-per-dispatch", "10",
                    "--bf16-compute", "--device-corpus"])]
    decode = ["--checkpoint-path", f"{RUN}/captioner",
              "--checkpoint-name", f"checkpoint_{a.cap_iters}"]
    if stage == "4":
        steps: List[Step] = [(f"stage4_decode_{senti}", [
            "inference", "--config", cfg, "--config-override", "DATA.SENTICAP_SENTIMENT",
            "" if senti == "neutral" else senti, *decode,
            "--output-path", f"{RUN}/preds_{senti}.json", "--batch-images", "8", "--bf16"])
            for senti in ("pos", "neg", "neutral")]
        return steps + [
            ("stage4_constraint_boxes", lambda: constraint_boxes(RUN, W)),
            ("stage4_decode_cbs", [
                "inference", "--config", cfg, "--config-override", "MODEL.USE_CBS", "true",
                "DATA.SENTICAP_SENTIMENT", "pos", "DATA.CBS.INFER_BOXES",
                f"{RUN}/constraint_boxes_test.json", *decode,
                "--output-path", f"{RUN}/preds_cbs_pos.json", "--batch-images", "8",
                "--bf16"])]
    if stage == "5":
        forms = ["--wordforms", f"{W}/wordforms_senti.tsv"]
        return [(f"stage5_eval_{name}", [
            "eval", "--predictions", f"{RUN}/preds_{name}.json",
            "--references", f"{W}/{refs}", *forms, "--output", f"{RUN}/eval_{name}.json"])
            for name, refs in (("neutral", "captions_test.json"),
                               ("pos", "captions_test_pos.json"),
                               ("neg", "captions_test_neg.json"))] + [
            ("stage5_baselines", ["eval_baselines", "--world", W, "--run", RUN,
                                  "--output", f"{RUN}/eval_baselines.json"]),
            ("stage5_style", ["style_report", "--world", W, "--run", RUN,
                              "--output", f"{RUN}/style_report.json"])]
    raise ValueError(f"unknown stage {stage!r}")


# the host-only CLIs take no --cpu flag
_HOST_CLIS = ("eval_detections", "eval", "eval_baselines", "style_report")


def cli_argv(cmd: List[str], cpu: bool) -> List[str]:
    """The subprocess's argv for a step's CLI command."""
    extra = ["--cpu"] if cpu and cmd[0] not in _HOST_CLIS else []
    return [sys.executable, "-m", f"style_seqcvae_tpu_torch.scripts.{cmd[0]}", *cmd[1:], *extra]


def run_cli(argv: List[str], log: Path, report: Path, name: str) -> int:
    """Run step ``name``'s CLI with its output copied line by line to
    ``log`` and to this process's stdout; returns its exit code."""
    env = dict(os.environ, **{LAUNCH_REPORT_ENV: str(report)})
    if env.get(KERNEL_INPUTS_ENV):
        env[KERNEL_INPUTS_ENV] = os.path.join(env[KERNEL_INPUTS_ENV], name)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    with open(log, "w") as f, subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1) as proc:
        for line in proc.stdout:
            f.write(line)
            sys.stdout.write(line)
        return proc.wait()


def main(argv: Optional[List[str]] = None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the exit
    code, the failing step's on a failure. ``RUN/three_stage.json`` holds
    ``stages``: each run stage's ``rc``, ``seconds``, ``launches`` (summed
    over its CLI processes) and ``steps``."""
    a = parser.parse_args(argv)
    unknown = sorted(set(a.stages) - set(STAGES))
    if unknown:
        parser.error(f"unknown stages {unknown}: choose from {' '.join(STAGES)}")
    a.world = str(ROOT / a.world)          # absolute as given, else under the root
    a.run = str(ROOT / a.run)
    run = Path(a.run)
    (run / "launches").mkdir(parents=True, exist_ok=True)
    summary: Dict[str, Any] = {"stages": {}}
    rc = 0
    for stage in [s for s in STAGES if s in a.stages]:
        print(f"=== stage {stage} ===", flush=True)
        record = {"rc": 0, "seconds": 0.0, "launches": {}, "steps": []}
        summary["stages"][stage] = record
        t_stage = time.perf_counter()
        for name, what in stage_steps(stage, a):
            t0 = time.perf_counter()
            if callable(what):
                step = {"name": name, "rc": what()}
            else:
                report = run / "launches" / f"{name}.json"
                report.unlink(missing_ok=True)
                cmd = cli_argv(what, a.cpu)
                step = {"name": name, "argv": cmd[1:],
                        "rc": run_cli(cmd, run / f"{name}.log", report, name)}
                if report.exists():
                    for k, n in json.loads(report.read_text()).items():
                        record["launches"][k] = record["launches"].get(k, 0) + n
            step["seconds"] = time.perf_counter() - t0
            record["steps"].append(step)
            if step["rc"]:
                record["rc"] = rc = step["rc"]
                print(f"three_stage: step {name} of stage {stage} exited {rc}", flush=True)
                break
        record["seconds"] = time.perf_counter() - t_stage
        print(json.dumps({"stage": stage, "rc": record["rc"], "seconds": record["seconds"],
                          "launches": record["launches"]}), flush=True)
        if rc:
            break
    (run / "three_stage.json").write_text(json.dumps(summary, indent=1))
    if not rc:
        print(f"three-stage pipeline complete: artifacts under {a.run}", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

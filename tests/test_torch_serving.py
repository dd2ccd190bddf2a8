"""The port's device FSM and serving path (``decoding/device_fsm.py``,
``serving.py``, ``scripts/serve.py``, ``scripts/load_test.py``) against the
JAX package, f32 on the CPU.

Every draw is JAX's: the Gumbel noise of the attribute picks and the
decode's z-noise are drawn here from JAX's own key splits and handed to the
port (``_jax_draws``). The serve CLIs agree byte for byte only where the
draws cannot matter (``PRIOR_STD 0``, one selectable attribute name): JAX's
keys and the port's ``torch.Generator`` give different numbers.
"""

import importlib.util
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from style_seqcvae_tpu.config import Config as JConfig
from style_seqcvae_tpu.data.latents import LatentDictionary as JLatentDictionary
from style_seqcvae_tpu.data.vocabulary import BOUNDARY_TOKEN, UNK_TOKEN
from style_seqcvae_tpu.data.vocabulary import Vocabulary as JVocabulary
from style_seqcvae_tpu.data.vocabulary import (
    add_constraint_words_to_vocabulary as j_add_constraint_words,
)
from style_seqcvae_tpu.decoding import device_fsm as jfsm
from style_seqcvae_tpu.models import captioner as jcap
from style_seqcvae_tpu.models.detector import faster_rcnn as jfr
from style_seqcvae_tpu.models.detector.rpn import RPNConfig
from style_seqcvae_tpu.serving import attribute_embeds_device as j_attribute_embeds
from style_seqcvae_tpu.serving import make_serve_fn as j_make_serve_fn
from style_seqcvae_tpu.utils.jit_init import jit_init
from style_seqcvae_tpu_torch.data.latents import LatentDictionary
from style_seqcvae_tpu_torch.data.vocabulary import Vocabulary
from style_seqcvae_tpu_torch.decoding import device_fsm as tfsm
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig
from style_seqcvae_tpu_torch.models.detector.faster_rcnn import DetectorConfig
from style_seqcvae_tpu_torch.ops.kernels._build import KernelError
from style_seqcvae_tpu_torch.scripts import load_test
from style_seqcvae_tpu_torch.scripts import serve as serve_cli
from style_seqcvae_tpu_torch.serving import attribute_embeds_device, make_serve_fn
from style_seqcvae_tpu_torch.weights import (
    from_jax_detector_params,
    from_jax_params,
    save_params_npz,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_serve_cli", REPO / "scripts" / "serve.py")
JCLI = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JCLI)
ATT_NAMES = ["wooden", "red", "blue", "furry", "plastic", "shiny", "tall"]
WORDFORMS = {n: [n] for n in ATT_NAMES}
# filler words: kernel A's selection needs k = beam // 2 + 3 · 5 <= V
TOKENS = [UNK_TOKEN, BOUNDARY_TOKEN, "a", "dog", "sits", "runs"] + ATT_NAMES + \
    [f"w{i}" for i in range(24)]
# the tiny world of tests/test_serving.py
DET_KW = dict(num_classes=5, num_att_classes=len(ATT_NAMES), depth=50, anchor_scales=(2, 4),
              anchor_ratios=(0.5, 1.0, 2.0))
PRE, POST, MAXB, K = 64, 16, 8, 3
CAP_KW = dict(image_feature_size=2048, hidden_size=6, attention_projection_size=4, z_space=4,
              simple_vae=False, max_caption_length=6, beam_size=2, use_cbs=True)
# log-probs: sums of 6 f32 log-softmax terms over ~1e2-scale pooled features,
# summed in other orders by XLA and the port
LP_RTOL = 1e-5


def _tables_equal(got, want):
    for f, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


# ---------------------------------------------------------------- device FSM


def test_wordform_table_matches_jax():
    names = ["wooden", "shiny metal", "red", "light blue", "blue", "furry", "plastic",
             "striped", "metal "]
    forms = {"wooden": ["wooden", "wood"], "metal": ["metal", "metallic"], "red": ["red"],
             "blue": ["blue"], "furry": ["furry", "fuzzy"], "plastic": ["plastic"]}
    words = sorted({w for f in forms.values() for w in f})
    want = jfsm.build_attribute_wordform_table(names, forms, JVocabulary(TOKENS[:5] + words))
    got = tfsm.build_attribute_wordform_table(names, forms, Vocabulary(TOKENS[:5] + words))
    _tables_equal(got, want)
    assert tfsm.clean_attribute_name("light blue") == jfsm.clean_attribute_name("light blue")
    assert tfsm.clean_attribute_name("metal ") == "metal"


def test_build_tables_device_matches_jax():
    """A grid of constraint sets: distinct, duplicated (a word wired into
    both bits), padded with -1 and empty, batched against JAX's vmap."""
    vocab = Vocabulary(TOKENS)
    jtable = jfsm.build_attribute_wordform_table(ATT_NAMES, WORDFORMS, JVocabulary(TOKENS))
    table = tfsm.build_attribute_wordform_table(ATT_NAMES, WORDFORMS, vocab)
    grid = np.array([[0, 2, 4], [5, 1, -1], [2, -1, -1], [-1, -1, -1], [2, 2, -1],
                     [3, 3, 3], [6, 0, 6], [-1, 4, -1]], np.int32)
    want = jax.vmap(lambda a: jfsm.build_tables_device(a, jtable))(jnp.asarray(grid))
    got = tfsm.build_tables_device(torch.from_numpy(grid).reshape(2, 4, 3), table)
    assert got.exc_token.shape == (2, 4, 8, 3 * tfsm.MAX_WORDFORMS)
    _tables_equal([t.reshape((8,) + tuple(t.shape[2:])) for t in got], want)
    shared = tfsm.tables_for_samples(torch.from_numpy(grid[None, :2]), table, n_z=3)
    assert shared.exc_valid.shape[:2] == (3, 2)
    assert torch.equal(shared.exc_valid[0], shared.exc_valid[2])


def test_select_attribute_constraints_matches_jax():
    """Batched over FSM samples and images on JAX's own Gumbel draws:
    class unions, canonical dedup (two names clean to one), the threshold
    and invalid boxes."""
    names = ATT_NAMES + ["light blue", "dark red"]
    jtable = jfsm.build_attribute_wordform_table(names, WORDFORMS, JVocabulary(TOKENS))
    table = tfsm.build_attribute_wordform_table(names, WORDFORMS, Vocabulary(TOKENS))
    rng = np.random.RandomState(0)
    F, B, M, A = 3, 5, 12, len(names)
    class_ids = rng.randint(1, 5, (B, M)).astype(np.int32)
    valid = rng.rand(B, M) > 0.25
    valid[4] = False                                    # an image without detections
    att_scores = rng.rand(B, M, A).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), F * B).reshape(F, B, -1)
    gumbel = np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (K, A))))(keys))
    want_ids, want_n = jax.vmap(jax.vmap(
        lambda c, v, s, k: jfsm.select_attribute_constraints(c, v, s, jtable, k),
        in_axes=(0, 0, 0, 0)), in_axes=(None, None, None, 0))(
        jnp.asarray(class_ids), jnp.asarray(valid), jnp.asarray(att_scores), keys)
    ids, n = tfsm.select_attribute_constraints(
        torch.from_numpy(class_ids), torch.from_numpy(valid), torch.from_numpy(att_scores),
        table, torch.from_numpy(gumbel), n_fsm=F)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n)[0])
    assert (n.numpy()[:4] > 0).all() and n[4] == 0 and (ids[:, 4] == -1).all()
    # the picks differ between samples: the draws are used
    assert len({tuple(ids[f].reshape(-1).tolist()) for f in range(F)}) > 1


def test_attribute_embeds_device_matches_jax():
    rng = np.random.RandomState(7)
    names = ["wooden brown", "red", "blue", "furry", "missing"]
    mean_choice = {n.split(" ")[0]: rng.randn(6).astype(np.float32) for n in names[:4]}
    want_table = JLatentDictionary(mean_choice, 6, multiplier=1.5).embed_table(names)
    table = LatentDictionary(mean_choice, 6, multiplier=1.5).embed_table(names)
    np.testing.assert_array_equal(table.table, want_table.table)
    att_scores = rng.rand(2, 4, len(names)).astype(np.float32)
    valid = np.array([[True, True, True, False], [False, True, True, True]])
    want = np.asarray(j_attribute_embeds(jnp.asarray(att_scores), jnp.asarray(valid),
                                         want_table, 0.5))
    got = attribute_embeds_device(torch.from_numpy(att_scores), torch.from_numpy(valid),
                                  table, 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------- serve


@pytest.fixture(scope="module")
def world():
    jvocab, vocab = JVocabulary(TOKENS), Vocabulary(TOKENS)
    jdet_cfg = jfr.DetectorConfig(**DET_KW, rpn=RPNConfig(pre_nms_top_n=PRE,
                                                         post_nms_top_n=POST,
                                                         anchor_scales=(2, 4)))
    jdet = jax.tree_util.tree_map(np.asarray, jfr.init_detector(jax.random.PRNGKey(0),
                                                                jdet_cfg))
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    return dict(jvocab=jvocab, vocab=vocab, jdet_cfg=jdet_cfg, jdet=jdet,
                tdet=from_jax_detector_params(jdet, device="cpu"),
                jtable=jfsm.build_attribute_wordform_table(ATT_NAMES, WORDFORMS, jvocab),
                table=tfsm.build_attribute_wordform_table(ATT_NAMES, WORDFORMS, vocab),
                images=images, im_info=np.tile([64, 64, 1.0], (2, 1)).astype(np.float32),
                sentiment=np.array([[1.0], [-1.0]], np.float32))


def _jax_draws(key, n_z, n_fsm, B, A, T, S, beam, z):
    """The draws of JAX's ``make_serve_fn`` from ``key``: ``split(key, 3)``
    into the selection's and the decode's keys; per (FSM sample, image) a
    ``gumbel(k, (max_constraints, A))``; per z the CBS's normals (first
    ``split(k)``, then ``split(rng, T - 1)``, shapes (B, 1, 1, z) and (B, S,
    beam, z)), in the port's (n_z, T, B, S, beam, z) layout."""
    _, sel_key, dec_key = jax.random.split(key, 3)
    sel_keys = jax.random.split(sel_key, n_fsm * B).reshape(n_fsm, B, -1)
    gumbel = np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (K, A))))(sel_keys))
    noise = np.zeros((n_z, T, B, S, beam, z), np.float32)
    for i, zk in enumerate(jax.random.split(dec_key, n_z)):
        rng, k0 = jax.random.split(zk)
        noise[i, 0, :, :1, :1] = np.asarray(jax.random.normal(k0, (B, 1, 1, z), jnp.float32))
        for t, kt in enumerate(jax.random.split(rng, T - 1), start=1):
            noise[i, t] = np.asarray(jax.random.normal(kt, (B, S, beam, z), jnp.float32))
    return gumbel, noise


SERVE_CASES = {
    "tied_per_z": dict(embedding_size=300, sentiment_vae=1, per_z_fsm=True, n_z=3),
    "untied_shared_fsm": dict(embedding_size=8, sentiment_vae=1, per_z_fsm=False, n_z=3),
    "tied_mode2": dict(embedding_size=300, sentiment_vae=2, per_z_fsm=True, n_z=2),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_matches_jax(world, case):
    """``serve`` against JAX's ``make_serve_fn`` on JAX's draws, f32:
    captions token-identical, log-probs rtol 1e-5, constraint counts equal.
    The tied head decodes through prehead (kernel A's plain version here),
    the untied one through the raw route; JAX through its raw route."""
    kw = dict(SERVE_CASES[case])
    emb, mode, per_z, n_z = (kw.pop(k) for k in ("embedding_size", "sentiment_vae",
                                                 "per_z_fsm", "n_z"))
    base = dict(CAP_KW, vocab_size=len(TOKENS), embedding_size=emb, sentiment_vae=mode)
    jcfg, tcfg = jcap.CaptionerConfig(**base), CaptionerConfig(**base)
    jcap_params = jax.tree_util.tree_map(np.asarray,
                                         jcap.init_captioner(jax.random.PRNGKey(1), jcfg))
    embeds = jembeds = None
    if mode == 2:
        rng = np.random.RandomState(3)
        mc = {n: rng.randn(4).astype(np.float32) for n in ATT_NAMES}
        jembeds = JLatentDictionary(mc, 4).embed_table(ATT_NAMES)
        embeds = LatentDictionary(mc, 4).embed_table(ATT_NAMES)
    common = dict(n_z=n_z, beam_size=2, max_boxes=MAXB, rpn_pre_nms_top_n=PRE,
                  rpn_post_nms_top_n=POST, per_z_fsm=per_z)
    jserve = j_make_serve_fn(world["jdet_cfg"], jcfg, world["jtable"], dtype="float32",
                             att_embed_table=jembeds, **common)
    serve = make_serve_fn(DetectorConfig(**DET_KW), tcfg, world["table"], dtype=torch.float32,
                          att_embed_table=embeds, device="cpu", **common)
    key = jax.random.PRNGKey(3)
    want = jax.tree_util.tree_map(np.asarray, jserve(
        world["jdet"], jcap_params, jnp.asarray(world["images"]), jnp.asarray(world["im_info"]),
        jnp.asarray(world["sentiment"]), key))
    gumbel, noise = _jax_draws(key, n_z, n_z if per_z else 1, 2, len(ATT_NAMES),
                               jcfg.max_caption_length, 2 ** K, 2, 4)
    best, lp, nc = serve(world["tdet"], from_jax_params(jcap_params, device="cpu"),
                         world["images"], world["im_info"], world["sentiment"],
                         gumbel=gumbel, noise=noise)
    np.testing.assert_array_equal(nc.numpy(), want[2])
    assert (want[2] > 0).all(), "the constraints are not exercised"
    np.testing.assert_array_equal(best.numpy(), want[0])
    np.testing.assert_allclose(lp.numpy(), want[1], rtol=LP_RTOL, atol=0)
    # the generator path draws its own noise: same shapes, finite
    b2, lp2, _ = serve(world["tdet"], from_jax_params(jcap_params, device="cpu"),
                       world["images"], world["im_info"], world["sentiment"],
                       generator=torch.Generator().manual_seed(0))
    assert b2.shape == best.shape and torch.isfinite(lp2).all()


def test_serve_mode2_needs_the_embed_table():
    cfg = CaptionerConfig(**dict(CAP_KW, vocab_size=len(TOKENS), embedding_size=8,
                                 sentiment_vae=2))
    table = tfsm.build_attribute_wordform_table(ATT_NAMES, WORDFORMS, Vocabulary(TOKENS))
    with pytest.raises(ValueError, match="att_embed_table"):
        make_serve_fn(DetectorConfig(**DET_KW), cfg, table, device="cpu")


# ------------------------------------------------------------------- CLIs

# the tiny detector and captioner as the serve CLIs build them from flags and
# the config; PRIOR_STD 0 and one selectable attribute name ("shiny"; "dull"
# has no wordforms) make every draw irrelevant
CLI_OVERRIDES = ["DET.ANCHOR_SCALES", "[2, 4]", "DET.TEST.SCALES", "[64]",
                 "DET.TEST.MAX_SIZE", "64", "DET.TEST.RPN_PRE_NMS_TOP_N", "64",
                 "DET.TEST.RPN_POST_NMS_TOP_N", "6"]
CLI_NAMES = ["shiny", "dull"]


def _write_cli_world(d: Path):
    d.mkdir(parents=True, exist_ok=True)
    Vocabulary([UNK_TOKEN, BOUNDARY_TOKEN, "a", "dog", "sits", "runs"]
               + [f"w{i}" for i in range(30)]).save_to_files(str(d / "vocab"))
    (d / "wordforms_attribs.tsv").write_text("shiny\tshiny,glossy\n")
    (d / "names.json").write_text(json.dumps(CLI_NAMES))
    (d / "cfg.yml").write_text(f"""RANDOM_SEED: 0
DATA:
  VOCABULARY: {d / 'vocab'}
  MAX_CAPTION_LENGTH: 6
  MAX_BOXES: 8
  CBS:
    WORDFORMS_ATTRIBS: {d / 'wordforms_attribs.tsv'}
MODEL:
  IMAGE_FEATURE_SIZE: 2048
  EMBEDDING_SIZE: 300
  HIDDEN_SIZE: 6
  ATTENTION_PROJECTION_SIZE: 4
  Z_SPACE: 4
  SENTIMENT_VAE: 1
  SIMPLE_VAE: false
  PRIOR_STD: 0.0
  N_Z_SAMPLES: 2
  STATE_MACHINE_PER_Z_SAMPLE: true
  BEAM_SIZE: 2
  USE_CBS: true
""")
    rng = np.random.RandomState(5)
    paths = []
    for k, hw in enumerate([(48, 64), (64, 48), (48, 64), (48, 64)]):
        path = d / f"img{k}.png"
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(path)
        paths.append(str(path))
    # the JAX CLI's weights, handed to the port as .npz files
    C = JConfig(str(d / "cfg.yml"), CLI_OVERRIDES)
    jvocab = JVocabulary.from_files(str(d / "vocab"))
    j_add_constraint_words(jvocab, C.DATA.CBS.WORDFORMS_ATTRIBS)
    det_cfg = jfr.DetectorConfig(num_classes=5, num_att_classes=len(CLI_NAMES), depth=50,
                                 pooling_mode="align", anchor_scales=(2, 4),
                                 anchor_ratios=(0.5, 1, 2), rpn=RPNConfig(anchor_scales=(2, 4)))
    save_params_npz(jax.tree_util.tree_map(np.asarray, jit_init(
        jfr.init_detector, det_cfg, jax.random.PRNGKey(0))), str(d / "det.npz"))
    cap_cfg = jcap.CaptionerConfig.from_config(C, jvocab)
    tokens = [jvocab.get_token_from_index(i) for i in range(jvocab.get_vocab_size())]
    emb = jcap.hashed_random_embeddings(tokens, cap_cfg.embedding_size, cap_cfg.pad_index)
    save_params_npz(jax.tree_util.tree_map(np.asarray, jit_init(
        jcap.init_captioner, cap_cfg, jax.random.PRNGKey(C.RANDOM_SEED), emb)),
        str(d / "cap.npz"))
    common = ["--config", str(d / "cfg.yml"), "--attrib-names-json", str(d / "names.json"),
              "--num-classes", "5", "--depth", "50", "--f32", "--cpu",
              "--config-override", *CLI_OVERRIDES]
    port = ["--checkpoint-path", str(d / "cap.npz"), "--det-checkpoint-path", str(d / "det.npz")]
    return common, port, paths


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    return _write_cli_world(tmp_path_factory.mktemp("serve_cli"))


def test_serve_cli_batch_mode_matches_jax_cli(cli_world, tmp_path, monkeypatch, capsys):
    """The whole batch-mode JSON, byte for byte: two canvas buckets (a
    portrait image), ``--batch-requests 2`` (a padded last group) and the
    request order."""
    common, port, paths = cli_world
    args = [*common, "--canvas", "64", "96", "--batch-requests", "2", "--image", *paths]
    monkeypatch.setattr("sys.argv", ["serve.py", *args, "--output", str(tmp_path / "jax.json")])
    JCLI.main()
    stats = {}
    assert serve_cli.main([*args, *port, "--output", str(tmp_path / "port.json")],
                          stats=stats) == 0
    log = capsys.readouterr().out
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    preds = json.loads(want)
    assert [p["image_id"] for p in preds] == paths
    assert len(stats["groups"]) == 3 and "warm-up: 2 bucket group(s)" in log
    assert ", 0 constraints" not in log and " constraints" in log


def _post(url, data, timeout=120):
    req = urllib.request.Request(f"{url}/caption?sentiment=-1", data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _start_server(args):
    """The serve CLI's HTTP mode on a thread; returns (thread, stats, rc
    list, url)."""
    stats, rc = {}, []
    server = threading.Thread(target=lambda: rc.append(serve_cli.main(args, stats=stats)))
    server.start()
    for _ in range(600):
        if "server" in stats or not server.is_alive():
            break
        time.sleep(0.1)
    return server, stats, rc, f"http://127.0.0.1:{stats['server'].server_address[1]}"


def test_serve_cli_http_mode_and_load_test(cli_world):
    common, port, paths = cli_world
    server, stats, rc, url = _start_server(
        [*common, *port, "--http", "0", "--canvas", "64", "96", "--batch-requests", "2",
         "--batch-wait-ms", "50", "--no-prewarm"])
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            assert json.loads(resp.read()) == {"ok": True}
        results = [None] * 3

        def fire(i):
            results[i] = _post(url, Path(paths[i]).read_bytes())

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for code, body in results:
            assert code == 200, body
            assert len(body["candidates"]) == 2 and body["num_constraints"] >= 1
            assert body["caption"] == body["candidates"][0]
        assert max(body["batch"] for _, body in results) >= 1
        code, body = _post(url, b"not an image")
        assert code == 400 and "bad request" in body["error"]
        jpeg = (REPO / "tests" / "fixtures" / "images" / "rgb420.jpg").read_bytes()
        code, body = _post(url, jpeg)
        assert code == 400 and "JPEG" in body["error"]
        rows = load_test.main(["--url", url, "--image", paths[0], "--rates", "2",
                               "--duration", "1"])
        assert len(rows) == 1 and rows[0]["errors"] == 0 and rows[0]["ok"] == 2
        assert rows[0]["p50_ms"] > 0
    finally:
        if "server" in stats:
            stats["server"].shutdown()
        server.join(timeout=60)
    assert not server.is_alive() and rc == [0]


def test_serve_cli_http_stops_after_a_card_fault(cli_world, monkeypatch):
    """A fault of the card answers 500 and ends the server: main returns 1."""
    common, port, paths = cli_world

    def fault(*args, **kwargs):
        raise KernelError("roi_align launch failed: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(serve_cli._Setup, "run_group", fault)
    server, stats, rc, url = _start_server([*common, *port, "--http", "0", "--canvas", "64",
                                            "96", "--no-prewarm"])
    try:
        code, body = _post(url, Path(paths[0]).read_bytes())
        assert code == 500 and "KernelError" in body["error"]
        server.join(timeout=60)
    finally:
        if server.is_alive():
            stats["server"].shutdown()
            server.join(timeout=60)
    assert not server.is_alive() and rc == [1]

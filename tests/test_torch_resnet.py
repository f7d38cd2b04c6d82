"""The port's ResNet-50 against the JAX package's on the CPU.

JAX's ``"SAME"`` padding is asymmetric at stride 2 (the odd row and column
at the end); the port pads explicitly with ``same_pads``, held here against
``jax.lax.padtype_to_pads`` at every stride and size the full and reduced
configs reach.  The logits agree with ``repro.models.resnet.ResNet.forward``
on bridged weights (``resnet_from_jax``: HWIO -> OIHW) within ``REL_TOL``
of the largest logit (float32: the convolutions sum in another order); the
same model with PyTorch's symmetric ``padding=`` must fail that check.  The
torch predictor against ``JaxModelPredictor("ref")``, the platform through
the manifest's image pipeline, and the client close the slice.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.core import NullTracer as RefNullTracer
from repro.core import OpenRequest as RefOpenRequest
from repro.core import make_predictor as ref_make_predictor
from repro.core.platform import builtin_manifests as ref_manifests
from repro.models.resnet import ResNet as JaxResNet
from repro.models.resnet import ResNetConfig as JaxResNetConfig
from repro_torch.core import (
    EvaluationRequest,
    NullTracer,
    OpenRequest,
    ScenarioSpec,
    Tracer,
    TraceLevel,
    TracingServer,
    client,
    make_predictor,
)
from repro_torch.core.platform import LocalPlatform, builtin_manifests
from repro_torch.models import ResNet, ResNetConfig, resnet_from_jax
from repro_torch.models.resnet import same_pads

# |port - jax| <= REL_TOL * max |jax| over the logits
REL_TOL = 1e-4
CONFIGS = {"reduced": ResNetConfig().reduced(), "full": ResNetConfig()}


def _jax_config(cfg: ResNetConfig) -> JaxResNetConfig:
    return JaxResNetConfig(name=cfg.name, stage_sizes=cfg.stage_sizes, width=cfg.width,
                           num_classes=cfg.num_classes, img_size=cfg.img_size)


def _jax_weights(cfg: ResNetConfig, seed: int):
    """The reference's weights with every folded norm's scale and bias
    drawn at random (ones and zeros would hide a norm applied over the
    wrong axis), as numpy."""
    params = jax.tree.map(np.asarray, JaxResNet(_jax_config(cfg)).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(node):
        if "scale" in node and "bias" in node:
            c = node["scale"].shape
            return {"scale": (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}
        return {k: perturb(v) if isinstance(v, dict) else v for k, v in node.items()}

    return perturb(params)


def _images(cfg: ResNetConfig, b: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


def _jax_logits(cfg, params, images):
    return np.asarray(jax.jit(JaxResNet(_jax_config(cfg)).forward)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(images)))


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


class SymmetricPadResNet(ResNet):
    """The port's model with PyTorch's symmetric ``padding=``: the same
    shapes as JAX's ``"SAME"``, shifted values at every stride 2."""

    @staticmethod
    def _conv(x, w, stride=1):
        return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)

    @staticmethod
    def _max_pool(x):
        return F.max_pool2d(x, 3, 2, padding=1)


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------
# (size, window, stride) of every padded layer of the full (224) and reduced
# (32) configs: the stem, the pool, each stage's 3x3/2 and 1x1/2 projection
# at its input size, a 3x3/1 and a 1x1/1
PAD_CASES = ([(224, 7, 2), (32, 7, 2), (112, 3, 2), (16, 3, 2)]
             + [(n, 3, 2) for n in (56, 28, 14, 8, 4, 2)]
             + [(n, 1, 2) for n in (56, 28, 14, 8, 4, 2)]
             + [(n, 3, 1) for n in (56, 7, 8, 1)] + [(56, 1, 1), (1, 1, 1)])


@pytest.mark.parametrize("n,k,stride", PAD_CASES)
def test_same_pads_equal_jax(n, k, stride):
    (want,) = jax.lax.padtype_to_pads((n,), (k,), (stride,), "SAME")
    assert same_pads(n, k, stride) == tuple(want)


def test_stride_two_padding_is_asymmetric():
    assert same_pads(224, 7, 2) == (2, 3) and same_pads(32, 7, 2) == (2, 3)
    assert same_pads(56, 3, 2) == (0, 1) and same_pads(112, 3, 2) == (0, 1)
    assert same_pads(56, 1, 2) == (0, 0) and same_pads(56, 3, 1) == (1, 1)


# ---------------------------------------------------------------------------
# parameters and the bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", list(CONFIGS))
def test_param_count_equals_the_reference(which):
    cfg = CONFIGS[which]
    specs = JaxResNet(_jax_config(cfg)).param_specs()
    assert ResNet(cfg, device="cpu").param_count() == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(specs))


def test_bridge_gives_the_port_layout():
    cfg = CONFIGS["reduced"]
    jparams = _jax_weights(cfg, seed=0)
    tparams = resnet_from_jax(jparams)
    fresh = ResNet(cfg, device="cpu").init(seed=0)
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(tparams) == shapes(fresh)
    # HWIO -> OIHW, element for element
    w = jparams["stages"]["1"]["0"]["conv2"]
    np.testing.assert_array_equal(tparams["stages"]["1"]["0"]["conv2"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    assert tparams["head"].shape == (8 * 4 * cfg.width, cfg.num_classes)
    bf16 = resnet_from_jax(jparams, dtype=torch.bfloat16)
    assert bf16["stem"]["conv"].dtype == torch.bfloat16


def test_init_is_seeded_and_on_device():
    model = ResNet(CONFIGS["reduced"], device="cpu")
    a, b, c = model.init(seed=3), model.init(seed=3), model.init(seed=4)
    assert model.dtype == torch.float32
    assert torch.equal(a["stem"]["conv"], b["stem"]["conv"])
    assert not torch.equal(a["stem"]["conv"], c["stem"]["conv"])
    assert torch.equal(a["stem"]["bn"]["scale"], torch.ones(16))


def test_model_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet(CONFIGS["reduced"])


@pytest.mark.parametrize("which", list(CONFIGS))
def test_macs_count_every_convolution_and_the_head(which, monkeypatch):
    """``macs`` against the products the forward really runs: each
    ``F.conv2d``'s output elements times its window and input channels,
    and the head."""
    cfg = CONFIGS[which]
    model = ResNet(cfg, device="cpu")
    counted = []
    conv2d = F.conv2d

    def counting(x, w, *a, **kw):
        out = conv2d(x, w, *a, **kw)
        counted.append(out.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return out

    monkeypatch.setattr(F, "conv2d", counting)
    with torch.inference_mode():
        model.forward(model.init(seed=0), torch.zeros(2, cfg.img_size, cfg.img_size, 3))
    assert model.macs(2) == sum(counted) + 2 * 8 * 4 * cfg.width * cfg.num_classes
    if which == "full":
        assert 4.0e9 < model.macs(1) < 4.2e9        # ResNet-50 v1.5 at 224


# ---------------------------------------------------------------------------
# logits against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which,batch", [("reduced", 2), ("full", 1)])
def test_logits_equal_jax(which, batch):
    """Full width at batch 1 takes ~10 s on the CPU (both packages)."""
    cfg = CONFIGS[which]
    jparams = _jax_weights(cfg, seed=0)
    images = _images(cfg, batch)
    want = _jax_logits(cfg, jparams, images)
    with torch.inference_mode():
        got = ResNet(cfg, device="cpu").forward(resnet_from_jax(jparams),
                                                torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (batch, cfg.num_classes)
    assert np.isfinite(want).all()
    assert _rel_err(got.numpy(), want) <= REL_TOL


def test_symmetric_padding_fails_the_check():
    """PyTorch's ``padding=`` gives JAX's shapes and other values: the
    check above sees the trap."""
    cfg = CONFIGS["reduced"]
    jparams = _jax_weights(cfg, seed=0)
    images = _images(cfg, 2)
    want = _jax_logits(cfg, jparams, images)
    with torch.inference_mode():
        got = SymmetricPadResNet(cfg, device="cpu").forward(resnet_from_jax(jparams),
                                                            torch.from_numpy(images))
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) > REL_TOL


def test_bf16_forward_runs_and_returns_float32():
    cfg = CONFIGS["reduced"]
    model = ResNet(cfg, device="cpu", dtype=torch.bfloat16)
    params = resnet_from_jax(_jax_weights(cfg, seed=0), dtype=torch.bfloat16)
    images = _images(cfg, 2)
    with torch.inference_mode():
        got = model.forward(params, torch.from_numpy(images))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = _jax_logits(cfg, _jax_weights(cfg, seed=0), images)
    assert _rel_err(got.numpy(), want) < 5e-2


# ---------------------------------------------------------------------------
# the predictor
# ---------------------------------------------------------------------------
def _manifests():
    ref = next(m for m in ref_manifests(reduced=True) if m.name == "resnet50")
    port = next(m for m in builtin_manifests(reduced=True) if m.name == "resnet50")
    return ref, port


@pytest.mark.parametrize("level", ["MODEL", "FRAMEWORK"])
def test_torch_predictor_matches_the_jax_predictor(level):
    ref_manifest, port_manifest = _manifests()
    jpred, tpred = ref_make_predictor("ref"), make_predictor("torch")
    jh = jpred.open(RefOpenRequest(manifest=ref_manifest, backend="ref"), RefNullTracer())
    th = tpred.open(OpenRequest(manifest=port_manifest, device="cpu"), NullTracer())
    assert th.state["kind"] == "resnet" and th.state["cfg"] == ResNetConfig().reduced()
    th.state["params"] = resnet_from_jax(jh.state["params"])
    images = _images(ResNetConfig().reduced(), 3, seed=5)
    want = np.asarray(jpred.predict(jh, images, RefNullTracer()))
    server = TracingServer()
    tracer = Tracer("t", server, TraceLevel[level])
    got = tpred.predict(th, images, tracer)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape
    assert _rel_err(got, want) <= REL_TOL
    # one image (H, W, 3) gets a batch axis
    one = tpred.predict(th, images[0], NullTracer())
    assert one.shape == (1, want.shape[1])
    # FRAMEWORK opens no layer span: MODEL's bits, one inference span
    assert np.array_equal(got, tpred.predict(th, images, NullTracer()))
    spans = server.timeline("t")
    assert [s.name for s in spans] == ["inference"]
    assert spans[0].tags["batch"] == 3
    tpred.close(th)
    assert th.state is None


def test_predictor_open_traces_the_load():
    _, port_manifest = _manifests()
    server = TracingServer()
    handle = make_predictor("torch").open(
        OpenRequest(manifest=port_manifest, device="cpu"),
        Tracer("load", server, TraceLevel.MODEL))
    assert [s.name for s in server.timeline("load")] == ["model_load", "weight_init"]
    assert handle.state["model"].dtype == torch.float32
    # the manifest's seed sets the weights
    again = ResNet(ResNetConfig().reduced(), device="cpu").init(seed=0)
    assert torch.equal(handle.state["params"]["head"], again["head"])


# ---------------------------------------------------------------------------
# the platform and the client
# ---------------------------------------------------------------------------
def test_platform_evaluates_resnet50_through_the_image_pipeline(tmp_path):
    p = LocalPlatform(backends=("torch",), evaldb_path=str(tmp_path / "r.sqlite"),
                      device="cpu")
    try:
        online = EvaluationRequest(
            model="resnet50", scenario=ScenarioSpec(kind="online", num_requests=3,
                                                    rate_hz=1000.0, warmup=1),
            trace_level="MODEL")
        (res,) = p.evaluate(online)
        assert res["model"] == "resnet50:1.5.0" and res["metrics"]["trimmed_mean_ms"] > 0
        batched = EvaluationRequest(
            model="resnet50", scenario=ScenarioSpec(kind="batched", num_requests=2,
                                                    batch_sizes=[1, 4], warmup=1),
            trace_level="MODEL")
        m = p.evaluate(batched)[0]["metrics"]
        assert m["optimal_batch_size"] in (1, 4) and m["max_throughput_ips"] > 0
        recs = p.evaldb.query(model="resnet50", backend="torch")
        assert sorted(r.scenario for r in recs) == ["batched", "online"]
        assert all(r.model_version == "1.5.0" for r in recs)
        names = {s["name"] for s in p.evaldb.spans(res["eval_id"])}
        assert {"evaluation", "model_load", "weight_init", "inference", "op:decode",
                "op:resize", "op:normalize", "op:argsort"} <= names
    finally:
        p.shutdown()


def test_client_evaluates_resnet50(capsys, tmp_path):
    db = str(tmp_path / "cli.sqlite")
    assert client.main(["--evaldb", db, "evaluate", "--device", "cpu", "--model", "resnet50",
                        "--scenario", "batched", "--batch-sizes", "1,2", "--num-requests",
                        "2", "--warmup", "1"]) == 0
    out = capsys.readouterr().out
    assert "optimal_batch_size" in out and "resnet50" in out

"""K6, the norm + GELU kernel (`ops.norm_gelu`, `csrc/norm_gelu.cu`).

On the CPU: `norm_gelu` runs its plain version, which is `layers`'
composition bit for bit (and the conv frontend's output with it), without
a launch; where autograd records the step the norms stay out of the kernel;
the argument checks raise before any library is loaded; the kernel's
constants are layers.py's rounded to f32; the frontend span counts its
conv outputs' elements and `frontend_fused.batch` reads them.

On the card (marked `cuda`; they skip here, since a CUDA kernel has no CPU
mode): the GELU against `layers.gelu_as` on every finite bf16 and f16 bit
pattern, bit for bit; the group and channel modes against `layers`' chains
by `chip_smoke.k6_norm_gap` (1 bf16 ulp of the norm where it is 2^-8 or
more in magnitude, 2^-16 nearer 0: the statistics are f32 sums in another
order, so a value near 0 can move many ulps or change sign), padded frames
0; whole bf16 forwards of wav2vec2-base and the conformer with and without
K6 within bench.py's log-prob gate, every conv output written by K6. This
file imports neither jax nor the JAX package; on a GPU machine run

    python -m pytest --noconftest tests/test_torch_port_norm_gelu.py -m cuda
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
from wav2vec2_tpu_torch.models import ctc_model, encoder, feature_extractor, layers
from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
from wav2vec2_tpu_torch.ops import cuda_build, norm_gelu as ng
from wav2vec2_tpu_torch.utils import spans

SOURCE = Path(ng.__file__).resolve().parent.parent / "csrc" / "norm_gelu.cu"
SMALL = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
    conv_dim=[16, 16, 16], conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2],
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, pad_token_id=0,
    vocab_size=32,
)
FRONTENDS = {
    "group": dict(SMALL, model_type="wav2vec2", do_stable_layer_norm=False,
                  feat_extract_norm="group", conv_bias=False),
    "layer": dict(SMALL, model_type="wav2vec2", do_stable_layer_norm=True,
                  feat_extract_norm="layer", conv_bias=True),
}
# bf16 inputs where ATen's libm call (expf or the division) differs from K6's
# on the card; none so far
GELU_DIFFERS: dict = {}


def _rows(dtype, b=3, c=8, t=41, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, c, t, generator=g) * 3 + 1).to(dtype)
    w = 1 + 0.2 * torch.randn(c, generator=g)
    bias = 0.2 * torch.randn(c, generator=g)
    return x, w, bias


def _bits(x):
    return x.view(torch.int16)


def _chain(x, norm=None, w=None, b=None, eps=1e-5, lens=None):
    """The composition as it stood before K6, every step an ATen operation:
    `gelu_as` of the `layers` norm."""
    if norm == "group":
        x = layers.group_norm_1d(x, w, b, x.shape[1], eps, ng.time_mask(lens, x.shape[2]))
    elif norm == "channel":
        x = layers.layer_norm_channels(x, w, b, eps)
    return layers.gelu_as(x)


def _old_frontend(params, audio, cfg, audio_lens):
    """`feature_extractor_forward` as it was before K6: each norm, then
    `layers.gelu`."""
    x, lens = audio[:, None, :], audio_lens
    eps = cfg.feature_layer_norm_eps or cfg.layer_norm_eps
    for i, (out_c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
        conv = params["conv_layers"][i]["conv"]
        bias = conv.get("bias")
        x = torch.nn.functional.conv1d(x, conv["weight"].to(x.dtype),
                                       None if bias is None else bias.to(x.dtype), stride=s)
        if cfg.feat_extract_norm == "layer":
            ln = params["conv_layers"][i]["layer_norm"]
            x = layers.layer_norm_channels(x, ln["weight"], ln["bias"], eps)
        elif i == 0:
            lens = (lens - k) // s + 1
            gn = params["conv_layers"][0]["layer_norm"]
            x = layers.group_norm_1d(x, gn["weight"], gn["bias"], out_c, eps,
                                     ng.time_mask(lens, x.shape[2]))
        x = layers.gelu(x)
    return x


def _model(frontend, seed=0):
    cfg = Wav2Vec2ModelConfig.from_dict(FRONTENDS[frontend])
    tree = init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for layer in tree["feature_extractor"]["conv_layers"]:
        for name, one in (("weight", 1.0), ("bias", 0.0)):
            if "layer_norm" in layer:
                a = layer["layer_norm"][name]
                layer["layer_norm"][name] = np.float32(one) + np.float32(0.2) * \
                    rng.standard_normal(a.shape, dtype=np.float32)
    return cfg, params_from_jax(tree)


def _audio(lens, seed=0):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = rng.standard_normal(n, dtype=np.float32)
    return torch.from_numpy(audio), torch.tensor(lens)


@pytest.fixture
def no_library(monkeypatch):
    """Loading the kernel library fails the test."""
    def refuse(*_):
        raise AssertionError("the kernel library was loaded")

    ng._library.cache_clear()
    monkeypatch.setattr(cuda_build, "library", refuse)
    monkeypatch.setattr(ng, "library", refuse)
    yield
    ng._library.cache_clear()


# --- the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("norm,lens", [(None, None), ("group", None), ("group", (41, 1, 30)),
                                       ("group", (0, 41, 40)), ("channel", None)])
def test_plain_version_is_the_layers_composition(dtype, norm, lens, no_library):
    x, w, b = _rows(dtype)
    lens = None if lens is None else torch.tensor(lens)
    before = dict(ng.launches)
    got = ng.norm_gelu(x, norm, w, b, 1e-5, lens)
    want = _chain(x, norm, w, b, 1e-5, lens)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(ng.reference(x, norm, w, b, 1e-5, lens)), _bits(want))
    if norm is None:
        assert torch.equal(_bits(layers.gelu(x)), _bits(want))
    assert ng.launches == before


@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_frontend_output_unchanged_on_the_cpu(frontend, dtype, no_library):
    cfg, params = _model(frontend)
    audio, lens = _audio([4000, 2500, 3111])
    fe = params["feature_extractor"]
    with torch.no_grad():
        got = feature_extractor.feature_extractor_forward(fe, audio.to(dtype), cfg, lens)
        want = _old_frontend(fe, audio.to(dtype), cfg, lens)
    assert got.dtype == dtype and torch.equal(got, want)


def test_grad_mode_keeps_the_norms_out_of_the_kernel(monkeypatch):
    """Where autograd records the step the norm is `layers`' out-of-place
    code and only the GELU reaches K6 (its forward runs with grad off), with
    `GeluAS`'s backward; without grad the whole chain goes to K6. A meta
    tensor stands in for the card, `_launch` for the kernel."""
    handed = []

    def launch(x, norm, *_):
        handed.append(norm)
        return torch.empty_like(x)

    monkeypatch.setattr(ng, "_launch", launch)
    x = torch.zeros(2, 4, 9, device="meta", dtype=torch.bfloat16)
    w = torch.ones(4, device="meta", requires_grad=True)
    b = torch.zeros(4, device="meta", requires_grad=True)
    for norm in ("group", "channel"):
        out = ng.norm_gelu(x, norm, w, b)
        assert out.requires_grad and out.shape == x.shape
        assert type(out.grad_fn).__name__ == "_KernelGeluBackward"
        assert ng._KernelGelu.backward is layers.GeluAS.backward
        with torch.no_grad():
            ng.norm_gelu(x, norm, w, b)
    assert handed == [None, "group", None, "channel"]


def test_grad_mode_on_the_cpu_equals_the_plain_chain_and_its_gradient():
    x, w, b = _rows(torch.bfloat16)
    lens = torch.tensor([41, 7, 30])
    for norm in ("group", "channel"):
        w1, b1 = w.clone().requires_grad_(), b.clone().requires_grad_()
        w2, b2 = w.clone().requires_grad_(), b.clone().requires_grad_()
        got = ng.norm_gelu(x, norm, w1, b1, 1e-5, lens if norm == "group" else None)
        want = _chain(x, norm, w2, b2, 1e-5, lens if norm == "group" else None)
        assert torch.equal(_bits(got), _bits(want.detach()))
        got.float().sum().backward()
        layers.gelu(layers.group_norm_1d(x, w2, b2, 8, 1e-5, ng.time_mask(lens, 41))
                    if norm == "group" else layers.layer_norm_channels(x, w2, b2, 1e-5)
                    ).float().sum().backward()
        assert torch.equal(w1.grad, w2.grad) and torch.equal(b1.grad, b2.grad)


@pytest.mark.parametrize("case,message", [
    (dict(dtype=torch.float32), "bfloat16 or float16"),
    (dict(norm="layer"), "norm must be one of"),
    (dict(shape=(2, 4)), "takes x \\[B, C, T\\]"),
    (dict(shape=(2, 1025, 3), norm="channel"), "C up to 1024"),
    (dict(weight=(3,)), "weight must be a \\[4\\]"),
    (dict(lens=torch.int64, norm=None), "group mode's frame counts"),
    (dict(lens=torch.float32), "lens must be \\[2\\] integers"),
])
def test_argument_checks_raise_before_any_library_load(case, message, no_library):
    shape = case.get("shape", (2, 4, 9))
    x = torch.zeros(shape, device="meta", dtype=case.get("dtype", torch.bfloat16))
    c = shape[1] if len(shape) == 3 else 4
    w = torch.ones(case.get("weight", (c,)), device="meta")
    lens = torch.ones(2, device="meta", dtype=case["lens"]) if "lens" in case else None
    with pytest.raises(ValueError, match=message):
        ng._launch(x, case.get("norm", "group"), w, torch.zeros(c, device="meta"), 1e-5, lens)
    if case.get("dtype") is None:  # norm_gelu takes the same path
        with pytest.raises(ValueError, match=message):
            ng.norm_gelu(x, case.get("norm", "group"), w, torch.zeros(c, device="meta"),
                         lens=lens)


def test_f32_off_the_cpu_runs_the_plain_version(monkeypatch):
    """The f32 forward keeps the exact-erf GELU and the f32 norms on the
    card: no launch, and nothing counted as fused."""
    monkeypatch.setattr(ng, "_launch", lambda *_: pytest.fail("launched K6 on f32"))
    x = torch.zeros(2, 4, 9, device="meta")
    w, b = torch.ones(4, device="meta"), torch.zeros(4, device="meta")
    for norm in ng.MODES:
        assert ng.norm_gelu(x, norm, w, b).dtype == torch.float32
    assert layers.gelu(x).shape == x.shape


def test_a_device_without_the_kernel_raises(no_library):
    x = torch.zeros(2, 4, 9, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no K6 kernel for device meta"):
        ng.norm_gelu(x)


def test_kernel_constants_are_the_f32_roundings_of_layers():
    text = SOURCE.read_text()
    found = dict(re.findall(r"constexpr float (k\w+) = (-?0x[0-9a-fA-Fp.+-]+)f;", text))
    want = {"kInvSqrt2": layers._INV_SQRT2, "kP": layers._AS_P,
            **{f"kA{i}": a for i, a in enumerate(layers._AS_A)}}
    assert set(found) == set(want)
    for name, value in want.items():
        assert float.fromhex(found[name]) == float(np.float32(value)), name


def test_channel_limit_matches_the_source():
    """The wrapper refuses the channel counts the launcher refuses, and the
    channel mode's slab fits a block's shared memory at the limit."""
    text = SOURCE.read_text()
    assert int(re.search(r"kMaxChannels = (\d+);", text)[1]) == ng.MAX_CHANNELS
    frames = int(re.search(r"kChanFrames = (\d+);", text)[1])
    assert ng.MAX_CHANNELS * frames * 2 <= cuda_build.MAX_SMEM_BYTES


def _frontend_spans(cfg, params, audio, lens):
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        ctc_model.wav2vec2_forward(params, audio, cfg, lens, torch.bfloat16)
    found = [s for s in spans.snapshot() if s.name == "forward.frontend"]
    spans.clear()
    return found


@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
def test_frontend_span_counts_its_conv_elements(frontend):
    cfg, params = _model(frontend)
    audio, lens = _audio([4000, 2500])
    t, elems = audio.shape[1], 0
    for c, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // s + 1
        elems += 2 * c * t
    (front,) = _frontend_spans(cfg, params, audio, lens)
    assert front.counts == {"elems": elems}  # the CPU: the plain version, no launch
    # a launch adds what it wrote to the innermost open span
    with profile(activities=[ProfilerActivity.CPU]):
        spans.clear()
        with spans.span("forward.frontend", elems=3):
            spans.tally(elems_fused=2)
            spans.tally(elems_fused=1, elems=4)
        (front,) = spans.snapshot()
    assert front.counts == {"elems": 7, "elems_fused": 3}
    # off, nothing is counted and nothing is recorded
    spans.clear()
    spans.tally(elems=1)
    assert spans.snapshot() == []


def _run_view(found):
    from portbench import run
    from portbench.trace import Trace

    origin = 1_790_000_000_000_000_000
    recorder = SimpleNamespace(spans=[("portbench.submit", origin, origin + 10**7)],
                               batches=[], drain_s=[])
    trace = Trace(window_s=1.0, kernels=[("k", 0.0, 0.5)],
                  host_ranges=[("portbench.submit", 0.0, 0.01)], busy_s=0.5)
    made = [SimpleNamespace(id=i, parent=None, name=name, start_ns=origin + i * 1000,
                            end_ns=origin + i * 1000 + 500, counts=counts, device_s=None)
            for i, (name, counts) in enumerate(found, 1)]
    return run.RunView(None, None, trace, recorder, {}, 1.0), made


@pytest.mark.parametrize("found,want", [
    ([("forward.frontend", {"elems": 300, "elems_fused": 300}),
      ("forward.frontend", {"elems": 100, "elems_fused": 0}),
      ("batching.enqueue", {})], 75.0),
    ([("forward.frontend", {"elems": 10, "elems_fused": 10})], 100.0),
    ([("forward.frontend", {})], None),  # a program whose spans carry no counts
    ([("batching.enqueue", {})], None),
])
def test_frontend_fused_reader(found, want, monkeypatch):
    from portbench import manifest

    view, made = _run_view(found)
    monkeypatch.setattr(spans, "snapshot", lambda: made)
    got = manifest.reader("frontend_fused.batch")(view)
    assert got == (None if want is None else pytest.approx(want))


# --- the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ulps(a, b):
    """|a − b| in units in the last place of a 16-bit float, both finite."""
    from chip_smoke import ordered_bits

    return (ordered_bits(a) - ordered_bits(b)).abs()


def _finite_patterns(dtype, device):
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = bits.view(dtype)
    return x[torch.isfinite(x.float())].to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gelu_bit_exact_on_every_finite_pattern(dtype):
    device = _card()
    x = _finite_patterns(dtype, device)
    before = ng.launches["gelu"]
    # vectors (aligned), a misaligned start (scalars), and a ragged tail
    for view in (x, x[1:], x[: 8 * 1000 + 5]):
        got = ng.norm_gelu(view)
        want = layers.gelu_as(view)
        off = (_bits(got) != _bits(want)).nonzero().flatten()
        listed = GELU_DIFFERS if dtype == torch.bfloat16 else {}
        differ = {int(v): (float(view[i]), int(_ulps(got[i:i + 1], want[i:i + 1])))
                  for i, v in zip(off.tolist(), _bits(view)[off].tolist())}
        assert set(differ) <= set(listed), differ
        assert all(u <= 1 for _, u in differ.values()), differ
    torch.cuda.synchronize()
    assert ng.launches["gelu"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t", [(2, 3, 41), (3, 4, 8 * 97 + 3), (2, 4, 25_600),
                                   (1, 2, 57_337), (1, 3, 120_001)])
def test_group_mode_within_an_ulp_of_the_chain(b, c, t):
    from chip_smoke import k6_norm_gap

    device = _card()
    x, w, bias = _rows(torch.bfloat16, b, c, t, seed=t)
    x, w, bias = x.to(device), w.to(device), bias.to(device)
    for lens in (None, torch.tensor(([1, t, t - 1] * b)[:b], device=device)):
        got = ng.norm_gelu(x, "group", w, bias, 1e-5, lens)
        assert k6_norm_gap(got, x, "group", w, bias, lens) <= 1
        if lens is not None:
            pad = ng.time_mask(lens, t)[:, None, :].expand_as(got)
            assert bool((got.float()[~pad] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t", [(2, 512, 41), (3, 512, 3200), (1, 512, 32), (2, 1024, 33),
                                   (2, 8, 100), (1, 1, 5)])
def test_channel_mode_within_an_ulp_of_the_chain(b, c, t):
    device = _card()
    x, w, bias = _rows(torch.bfloat16, b, c, t, seed=c + t)
    x, w, bias = x.to(device), w.to(device), bias.to(device)
    from chip_smoke import k6_norm_gap

    got = ng.norm_gelu(x, "channel", w, bias, 1e-5)
    assert k6_norm_gap(got, x, "channel", w, bias, None) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["base", "conformer"])
def test_whole_forward_with_and_without_k6(name, monkeypatch):
    """A bf16 forward (2 layers at full width) with K6 against the same
    forward on `layers`' ATen chains: bench.py's log-prob gate over the
    valid frames; K6 launched on every conv and every encoder GELU, and the
    frontend span's `elems_fused` all of its `elems`."""
    from chip_smoke import BASE_CONFIG, CONFORMER_CONFIG, lp_gate, perturb_tree

    device = _card()
    cfg_dict = {**(BASE_CONFIG if name == "base" else CONFORMER_CONFIG), "num_hidden_layers": 2}
    cfg = Wav2Vec2ModelConfig.from_dict(cfg_dict)
    params = params_from_jax(perturb_tree(init_params(cfg, seed=3), 4), device=device)
    audio, lens = _audio([48_000, 31_999, 16_001, 40_000], seed=5)
    audio, lens = audio.to(device), lens.to(device)

    def forward():
        with torch.inference_mode():
            logits = ctc_model.wav2vec2_forward(params, audio, cfg, lens, torch.bfloat16)
            return torch.log_softmax(logits, -1).cpu().numpy()

    before = dict(ng.launches)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        lp = forward()
        torch.cuda.synchronize()
    (front,) = [s for s in spans.snapshot() if s.name == "forward.frontend"]
    spans.clear()
    assert front.counts["elems_fused"] == front.counts["elems"] > 0
    n_conv = len(cfg.conv_dim)
    want = ({"group": 1, "gelu": n_conv - 1 + 1 + cfg.num_hidden_layers, "channel": 0}
            if name == "base" else {"group": 0, "gelu": 0, "channel": n_conv})
    assert {k: ng.launches[k] - before[k] for k in want} == want
    monkeypatch.setattr(feature_extractor, "norm_gelu", ng.reference)
    monkeypatch.setattr(encoder, "norm_gelu", ng.reference)
    ref = forward()
    t_lens = ctc_model.frame_lengths(cfg, lens.cpu()).numpy()
    lp_gate(lp, ref, t_lens, f"{name}: K6 against the ATen chains")

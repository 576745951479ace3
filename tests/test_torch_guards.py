"""Guards of the PyTorch port: it, its scripts for the card, its benchmarks
(``benchmarks_torch/``) and examples (``examples_torch/``) import neither
JAX nor the JAX package, its copies of the JAX-free middleware
stay equal to their originals up to the package name in import lines, and
every attention config it runs by default, and every full config of the
repo, fits both attention kernels,
every hybrid one the SSD kernel and every rwkv6 one the WKV6 kernel."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MIDDLEWARE = [
    "core/__init__.py", "core/task.py", "core/resources.py", "core/policy.py",
    "core/request.py", "core/prefix.py", "core/events.py", "core/router.py",
    "core/autoscale.py", "core/service.py", "core/middleware.py",
    "backends/base.py", "backends/local.py", "serving/qos.py",
    "core/agent.py", "core/coupling.py",
]
_FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py", ROOT / "bench_flash.py",
     ROOT / "bench_decode.py", ROOT / "bench_ssd.py",
     ROOT / "profile_engine.py",
     ROOT / "profile_train.py", ROOT / "repeat_state_serving.py",
     *(ROOT / "benchmarks_torch").glob("*.py"),
     *(ROOT / "examples_torch").glob("*.py")]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]
    assert not bad, f"{path.name} imports {bad}"


LAUNCHERS = {"serve": "repro_torch.launch.serve",
             "train": "repro_torch.launch.train",
             "dryrun": "repro_torch.launch.dryrun",
             "benchmarks": "benchmarks_torch.run"}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_launcher_import_loads_no_jax(launcher):
    code = (f"import sys, {LAUNCHERS[launcher]}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', "
            "'benchmarks')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _rewrite(text):
    return "".join(
        re.sub(r"\brepro\.", "repro_torch.", line)
        if re.match(r"\s*(from|import)\s", line) else line
        for line in text.splitlines(keepends=True))


@pytest.mark.parametrize("rel", MIDDLEWARE)
def test_middleware_copy_equals_original(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == _rewrite(original)


def _launched_configs():
    """(label, config) for what the two launchers pick by default (every
    arch's smoke config but rhapsody-demo's full one) and the full configs
    ``chip_smoke.py`` runs; ``get_model`` serves every family."""
    from repro_torch.configs import get_config, get_smoke_config, list_archs
    from repro_torch.models import get_model

    picked = [(f"{a}-smoke", get_smoke_config(a)) for a in list_archs()]
    picked += [(f"{a}-full", get_config(a)) for a in
               ("rhapsody-demo", "llama3.2-3b", "rwkv6-1.6b", "zamba2-2.7b",
                "deepseek-moe-16b", "whisper-small", "internvl2-1b",
                "nemotron-4-340b")]
    for _, cfg in picked:
        get_model(cfg)
    return picked


SERVED = _launched_configs()
# rwkv6 runs no attention kernel
LAUNCHED = [(label, cfg) for label, cfg in SERVED if cfg.family != "ssm"]


@pytest.mark.parametrize("label,cfg", LAUNCHED, ids=[c[0] for c in LAUNCHED])
def test_launched_configs_fit_both_attention_kernels(label, cfg):
    """A CUDA tensor never takes the plain path, so a config whose head
    dim or group the kernels refuse fails on the card at its first decode
    step or forward (ROADMAP Queue 3, fault 1)."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops

    assert cfg.head_dim in decode_ops.KERNEL_HEAD_DIMS, label
    assert cfg.head_dim in flash_ops.KERNEL_HEAD_DIMS, label
    assert cfg.n_heads // cfg.n_kv_heads <= decode_ops.KERNEL_MAX_GROUP, label


def _full_attention_configs():
    from repro_torch.configs import get_config, list_archs

    return [(a, get_config(a)) for a in list_archs()
            if get_config(a).family != "ssm"]


FULL = _full_attention_configs()


@pytest.mark.parametrize("arch,cfg", FULL, ids=[c[0] for c in FULL])
def test_every_full_config_fits_both_attention_kernels(arch, cfg):
    """No config the repo defines is refused on the card: every full
    config but rwkv6's (no attention) has a head dim both attention
    kernels take and a group the decode kernel takes (nemotron-4-340b's
    head_dim 192 and 12 query heads a kv head among them)."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops

    assert cfg.head_dim in decode_ops.KERNEL_HEAD_DIMS, arch
    assert cfg.head_dim in flash_ops.KERNEL_HEAD_DIMS, arch
    assert cfg.n_heads // cfg.n_kv_heads <= decode_ops.KERNEL_MAX_GROUP, arch


def _qkv(Hq, Hkv, D, dtype=torch.bfloat16):
    return (torch.zeros(1, 1, Hq, D, dtype=dtype),
            torch.zeros(1, 8, Hkv, D, dtype=dtype),
            torch.zeros(1, 8, Hkv, D, dtype=dtype))


@pytest.mark.parametrize("Hq,Hkv,D,ok", [
    (96, 8, 192, True), (12, 1, 192, True), (16, 1, 128, True),
    (8, 1, 96, False), (24, 2, 96, False), (17, 1, 64, False),
    (34, 2, 192, False)], ids=lambda x: str(x))
def test_kernel_limits_take_nemotron_and_refuse_the_rest(Hq, Hkv, D, ok):
    """The limits both wrappers check before a CUDA launch: head_dim 192
    and up to 16 query heads a kv head are taken (nemotron-4-340b's 192
    and 12); a head dim outside the list (96) or a group above 16 is
    refused, so neither reaches a kernel that has no instantiation for
    it."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q, k, v = _qkv(Hq, Hkv, D)
    if ok:
        decode_ops._check_kernel_limits(q, k, v)
    else:
        with pytest.raises(ValueError, match="head_dim|query heads"):
            decode_ops._check_kernel_limits(q, k, v)
    fq = q.expand(1, 8, Hq, D).contiguous()
    if D == 96:
        with pytest.raises(ValueError, match="head_dim"):
            flash_ops._check_kernel_limits(fq, k, v)
    else:
        flash_ops._check_kernel_limits(fq, k, v)


HYBRID = [(label, cfg) for label, cfg in LAUNCHED if cfg.family == "hybrid"]


@pytest.mark.parametrize("label,cfg", HYBRID, ids=[c[0] for c in HYBRID])
def test_launched_hybrid_configs_fit_the_ssd_kernel(label, cfg):
    """Every hybrid config the launchers or ``chip_smoke.py`` run (the
    smoke config and zamba2-2.7b's full one) fits the bf16 SSD body's
    (N, P, chunk) limits (``check_bf16_shape`` raises where it refuses)."""
    from repro_torch.kernels.mamba2 import kernel, ops
    from repro_torch.models.mamba2 import ssm_dims

    _, H, N, _ = ssm_dims(cfg)
    P, L = cfg.ssm_head_dim, cfg.ssm_chunk
    assert L <= ops.KERNEL_MAX_CHUNK, label
    kernel.check_bf16_shape(P, N, L)


SSM = [(label, cfg) for label, cfg in SERVED if cfg.family == "ssm"]


@pytest.mark.parametrize("label,cfg", SSM, ids=[c[0] for c in SSM])
def test_launched_ssm_configs_fit_the_wkv_kernel(label, cfg):
    """Every rwkv6 config the launchers or ``chip_smoke.py`` run (the smoke
    config and rwkv6-1.6b's full one) fits the bf16 WKV6 body's (hd,
    chunk) limits (``check_bf16_shape`` raises where it refuses) and the
    float32 body's shared memory (``check_f32_shape``); a shorter prompt
    runs a shorter chunk, which fits wherever the full chunk does."""
    from repro_torch.kernels.rwkv6 import kernel

    kernel.check_bf16_shape(cfg.rwkv_head_dim, cfg.rwkv_chunk)
    kernel.check_f32_shape(cfg.rwkv_head_dim, cfg.rwkv_chunk)


@pytest.mark.parametrize("path", sorted((PORT / "models").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_models_import_nothing_above_them(path):
    """The models sit below the launch tooling and the serving pools: no
    model module imports them, at its top or inside a function (the
    cache's layout rule lives in ``models/nn.py``)."""
    above = re.compile(r"^repro_torch\.(launch|serving)(\.|$)")
    bad = [m for m in _imported_modules(path) if above.match(m)]
    assert not bad, f"{path.name} imports {bad}"

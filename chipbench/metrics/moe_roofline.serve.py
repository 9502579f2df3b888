"""``moe_roofline.serve``: the dropless MoE's grouped expert products'
share of their roofline over the traced ticks' prefills and decodes. The
work is read from the program's ``moe.experts`` spans inside the traced
window (``moe_counts.moe_flop_bytes``: 6·D·F operations an assignment; the
three bf16 matrices of each expert hit read once, 3·D·F·2 bytes, and a
token row read and an output row written an assignment, 2·D·2 bytes). The
time is the device time of the kernels of PyTorch's bf16 grouped GEMM
(``torch._grouped_mm`` on sm90, torch 2.11): CUTLASS's
``cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_for_sm9x<
cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::GroupProblemShape<...``,
which the profiler names mangled (``_ZN7cutlass13device_kernel...``, cut
at 120 characters), three a call, and ``prepare_grouped_gemm_data``, its
set-up, one a product.
Nothing is read unless the port counted as many grouped expert calls
(``moe_experts``) and recorded as many ``moe.experts`` spans as the traced
prefills and decodes have MoE layers (every layer of a ``layer_pattern``
config has one). Layer: the kernels (``kernels/moe_experts.py``)."""
from chipbench import counts
from chipbench.moe_counts import moe_flop_bytes


def grouped_gemm(name: str) -> bool:
    return name == "prepare_grouped_gemm_data" or (
        "cutlass13device_kernel" in name and "GroupProblem" in name)


def read(run):
    try:
        from repro_torch.profile.spans import PROFILED
    except ImportError:  # a program that records no program spans
        return None
    t = run.trace  # the harness's DeviceTrace keeps its window's start as _t0
    if t is None or not t.window_s or not run.peaks:
        return None
    spans = PROFILED.between(t._t0, t._t0 + t.window_s)
    steps = sum(s.name in ("engine.prefill", "engine.decode") for s in spans)
    moe = [s.args for s in spans if s.name == "moe.experts"]
    want = run.config["sizes"]["num_layers"] * steps
    if not steps or len(moe) != want or run.traced["launches"].get("moe_experts") != want:
        return None
    if not all(isinstance(a.get("experts_hit"), int) for a in moe):
        return None
    secs, _ = t.kernel_seconds(grouped_gemm)
    sz = run.config["sizes"]
    flop = nbytes = 0
    for a in moe:
        f, b = moe_flop_bytes(sz["d_model"], sz["d_ff"], a["assignments"], a["experts_hit"], 2)
        flop += f
        nbytes += b
    return counts.roofline_pct(flop, nbytes, secs, run.peaks)

"""Kernel 3 (``ops.pa_trigger``, ``pa_trigger_kernel``): the least time the
card could take for the phased-array chain problems of the profiled job
(rows, K, channels, beams, n_base, n_hi, decimation, upsampling, window and
step of each op-level call), over the kernel's device time there."""

from portbench import roofline

OP = {"module": "nuradiomc_tpu_torch.ops.pa_trigger", "attr": "fused_pa_trigger",
      "name": "pa_trigger", "kernel": "pa_trigger_kernel"}


def problem(args, kw):
    spec_re = args[0]
    return {"e": spec_re.element_size(), "R": spec_re.shape[0], "K": spec_re.shape[1],
            "C": kw["C"], "B": len(kw["rolls"]), "n_base": kw["n_base"], "n_hi": kw["n_hi"],
            "decim": kw["decim"], "up": kw["up"], "window": kw["window"], "step": kw["step"]}


def read(rec):
    from portbench.metrics_common import roofline_share
    return roofline_share(rec, OP, roofline.pa_bound)

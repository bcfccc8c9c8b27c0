"""Kernel 2 (``ops.trigger_fused``, ``irfft_trigger_kernel``): the least time
the card could take for the fused irfft-and-trigger problems of the profiled
job (rows, K, triggers, channels, n_base of each op-level call), over the
kernel's device time there."""

from portbench import roofline

OP = {"module": "nuradiomc_tpu_torch.ops.trigger_fused", "attr": "fused_irfft_trigger",
      "name": "irfft_trigger", "kernel": "irfft_trigger_kernel"}


def problem(args, kw):
    spec_re, _, th_hi = args[:3]
    return {"e": spec_re.element_size(), "R": spec_re.shape[0], "K": spec_re.shape[1],
            "T": th_hi.shape[1], "C": kw["C"], "n_base": kw["n_base"]}


def read(rec):
    from portbench.metrics_common import roofline_share
    return roofline_share(rec, OP, roofline.trigger_bound)

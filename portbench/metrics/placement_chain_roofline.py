"""Kernel 1 (``ops.placement``, ``placement_chain_kernel``): the least time
the card could take for the placement-chain problems of the profiled job,
over the kernel's device time there. The problem of each call is taken from
the op-level call's inputs (rows, live rows, K_int, K_place, n_int, n_base),
not from the kernel's grid."""

from portbench import roofline

OP = {"module": "nuradiomc_tpu_torch.ops.placement", "attr": "chain_placement_reduce",
      "name": "placement_chain", "kernel": "placement_chain_kernel"}


def problem(args, kw):
    spec_re, _, att, _, _, mask, _, _, W, tpl = args[:10]
    return {"e": spec_re.element_size(), "R": spec_re.shape[0], "K_int": spec_re.shape[1],
            "n_sparse": att.shape[1], "K_place": kw["K_place"], "live": mask.sum(),
            "s2": kw["s2"], "n_int": kw["n_int"], "n_base": kw["n_base"],
            "W_numel": W.numel(), "tpl_numel": tpl.numel()}


def read(rec):
    from portbench.metrics_common import roofline_share
    return roofline_share(rec, OP, roofline.placement_chain_bound)

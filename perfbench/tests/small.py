"""A cell's plan cut to a size the CPU runs in seconds: the program's
reduced model of the same family (its published widths replaced by the
reduced ones in the configuration) and a mix of a few slots and short
prompts.  Only the CPU tests use it."""

from __future__ import annotations

import copy
import dataclasses

from perfbench import harness

SMALL_MIX = {
    "shared-prefix": {"serving": {"slots": 6, "prompt_len": 64,
                                  "max_len": 80, "n_pages": 36},
                      "out_len": [4, 16], "namespaces": 2, "prefix_len": 48,
                      "tail_len": 16, "ramp": 3, "warmup_rounds": 3,
                      "check_tokens": 192, "check_requests": 16},
    "unshared": {"serving": {"slots": 6, "prompt_len": 64, "max_len": 80,
                             "n_pages": 30},
                 "prompt_len": [64, 64], "out_len": [4, 16], "ramp": 3,
                 "warmup_rounds": 3, "check_tokens": 192,
                 "check_requests": 16},
    "long-prompt": {"serving": {"slots": 4, "prompt_len": 32, "max_len": 48,
                                "n_pages": 12},
                    "prompt_len": [8, 32], "out_len": [4, 16], "ramp": 2,
                    "warmup_rounds": 3, "check_tokens": 288,
                    "check_requests": 24},
}


def small_plan(workload: str, dtype: str = "float32", root=harness.ROOT):
    """(plan, program model config) of ``workload`` at a small size: the
    cell's mix is replaced by :data:`SMALL_MIX`'s of its name, where there
    is one (a mix without one is taken as it is)."""
    from repro_torch.configs import get_reduced

    plan = harness.load_plan(workload, root)
    conf = copy.deepcopy(plan.conf)
    cfg = get_reduced(conf["program"]["arch"])
    cfg = dataclasses.replace(cfg, dtype=dtype)
    conf.update(hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
                num_attention_heads=cfg.n_heads,
                num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.d_head,
                vocab_size=cfg.vocab, rope_theta=cfg.rope_theta,
                torch_dtype=dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=conf["prefill_capacity_factor"]))
        conf.update(n_routed_experts=cfg.moe.n_experts,
                    num_experts_per_tok=cfg.moe.top_k,
                    moe_intermediate_size=cfg.moe.expert_d_ff,
                    n_shared_experts=cfg.moe.n_shared_experts)
        assert cfg.moe.shared_d_ff == cfg.moe.expert_d_ff
    else:
        conf["intermediate_size"] = cfg.d_ff
    small = copy.deepcopy(SMALL_MIX.get(plan.workload["traffic"], {}))
    mix = dict(plan.mix, **small)
    mix["serving"] = dict(plan.mix["serving"], **small.get("serving", {}))
    return dataclasses.replace(plan, conf=conf, mix=mix), cfg

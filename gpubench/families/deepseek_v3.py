"""The program's side of a DeepSeek-V3 configuration: the port's
``models.deepseek.DeepseekV3`` holding the block of routed experts the
configuration gives (``held_first``, ``n_routed_experts`` of the router's
``router_experts``), built on the ``meta`` device and handed the seeded
weights without a copy. Each batch's input is also replayed once through
the program's forward, with gradients on as the capture runs it, to hand
the reference the experts the program chose at every MoE layer: the
reference takes them where its own choice differs by a rounding tie
(``reference/deepseek_v3.py``)."""
import weakref

import torch

from gpubench.reference import deepseek_v3 as reference

#: a weak reference to the last model built (the replay's model; the run
#: frees the model before the reference runs)
_BUILT = [None]

#: the configuration keys the port's constructor takes
KEYS = ("vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "kv_lora_rank", "intermediate_size",
        "moe_intermediate_size", "n_shared_experts", "num_experts_per_tok",
        "first_k_dense_replace", "routed_scaling_factor", "norm_topk_prob",
        "rms_norm_eps", "rope_theta")


def build(cfg, weights, device):
    from curvature_tpu_torch.models.deepseek import DeepseekV3
    with torch.device("meta"):
        model = DeepseekV3(
            n_routed_experts=cfg["router_experts"],
            held=(cfg["held_first"], cfg["n_routed_experts"]),
            **{k: cfg[k] for k in KEYS})
    model.load_state_dict(weights, assign=True)
    _BUILT[0] = weakref.ref(model)
    return model


def program_input(cfg, x: torch.Tensor) -> torch.Tensor:
    """Token ids as they are; the program's routes of ``x`` go to the
    reference."""
    from curvature_tpu_torch.nn import MoE
    model = _BUILT[0]()
    chosen, hooks = [], []
    for m in model.modules():
        if isinstance(m, MoE):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: chosen.append(
                    mod.select(args[0].reshape(-1, args[0].shape[-1]))[0]
                    .detach())))
    try:
        with torch.enable_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    reference.give_routes(x, chosen)
    return x

"""Model code of the port (``repro.models``): the GQA decoder with a
SwiGLU (dense) or a mixture of experts (moe), the RWKV6 stack (ssm), and
Zamba2's Mamba2 blocks behind a shared decoder block (hybrid).

Params are nested dicts of tensors with the reference's keys and layouts
(``wq`` is (D, H, hd); layer stacks carry a leading L axis, Zamba2's
Mamba2 stack (groups, per)), so
``repro_torch.convert.lm_params_from_numpy`` hands the JAX params across
leaf for leaf.
"""

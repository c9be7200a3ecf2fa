"""Model code of the port (``repro.models``): the dense GQA decoder.

Params are nested dicts of tensors with the reference's keys and layouts
(``wq`` is (D, H, hd); layer stacks carry a leading L axis), so
``repro_torch.convert.lm_params_from_numpy`` hands the JAX params across
leaf for leaf.
"""

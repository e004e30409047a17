"""The reference's `io/registry.py` is not ported yet (ROADMAP Queue 1 item
15(h)): importing this module raises NotImplementedError naming it."""
raise NotImplementedError(
    "mmlspark_tpu_torch.io.registry is not ported yet (ROADMAP Queue 1 item "
    "15(h))")

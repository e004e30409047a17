"""The reference's `io/shared.py` is not ported yet (ROADMAP Queue 1 item
27): importing this module raises NotImplementedError naming it."""
raise NotImplementedError(
    "mmlspark_tpu_torch.io.shared is not ported yet (ROADMAP Queue 1 item "
    "27)")

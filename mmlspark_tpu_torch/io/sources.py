"""The reference's `io/sources.py` is not ported yet (ROADMAP Queue 1 item
27): importing this module raises NotImplementedError naming it."""
raise NotImplementedError(
    "mmlspark_tpu_torch.io.sources is not ported yet (ROADMAP Queue 1 item "
    "27)")

"""Placement of serving trees over a ``(data, model)`` mesh (counterpart of
``repro/distributed``).  Placements are plain tuples, one entry per dim:
``None`` or a mesh axis name."""

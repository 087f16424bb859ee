"""Sharding (twin of the ``clients`` half of ``repro/sharding``): the
process-wide ``DeviceMesh`` the cohort-parallel executor runs over, and
which client slots each rank holds (``ctx.py``)."""

"""Checkpoints of a train state in the reference's on-disk layout
(``io``), so that either package restores the other's, and the elastic
restore onto another mesh (``reshard``)."""

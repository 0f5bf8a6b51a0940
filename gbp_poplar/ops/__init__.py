"""Batched compute: Lie groups, projection, small-matrix linalg, and the
plane-layout algebra of the message-passing sweep."""

from . import lie, linalg, planes, projection  # noqa: F401

"""Bytes a piece of work needs, from its shapes, and the chip's peaks."""

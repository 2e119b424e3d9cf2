"""Segment ops, the fused activation kernel and the layout decode."""

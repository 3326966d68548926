"""Viewer-side helpers.  Only the keyboard listener is ported so far; the
terminal and window viewers are ROADMAP A10."""

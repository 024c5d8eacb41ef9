"""Annotation parsing, text normalisation and span linking (host side)."""

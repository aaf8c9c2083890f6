"""Imaging pipelines and their file entry points."""

"""Helpers around the ops: synthetic pages for smoke runs and timing."""

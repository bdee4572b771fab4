"""Deployment tools: the serving program (``export_program``)."""

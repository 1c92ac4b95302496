"""Inference pipeline: template bank, template selection, stage-2 poses."""

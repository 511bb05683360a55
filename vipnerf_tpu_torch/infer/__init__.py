"""Inference: tiled full-image rendering and the novel-view tester."""

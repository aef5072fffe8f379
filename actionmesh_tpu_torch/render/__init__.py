"""Preview rendering: orbit cameras, a z-buffer mesh renderer, the visualizer."""

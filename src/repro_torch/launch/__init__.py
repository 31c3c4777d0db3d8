"""Cells: an arch under a shape, as a step function and its inputs."""

"""Architecture configurations the port runs (``registry.ARCHS``)."""

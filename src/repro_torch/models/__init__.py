"""Models: VGG-16 on the L2R path."""

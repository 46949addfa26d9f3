"""Multi-task gradient surgery for the discriminator update."""

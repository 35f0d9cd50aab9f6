"""Head configuration, DSAC and the assembled predict path."""

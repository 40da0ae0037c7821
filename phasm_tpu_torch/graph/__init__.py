"""String-graph passes that run on the device (transitive reduction); the
other cleaning passes are the reference's host code."""

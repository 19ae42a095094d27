"""The filter: state, propagation, tracks, verification, update, window."""

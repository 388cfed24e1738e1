"""Host-side file codecs of the predict path (numpy; PIL for images)."""

"""Host-side data contracts and image transforms."""

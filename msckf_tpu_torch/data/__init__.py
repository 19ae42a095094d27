"""Host-side data: the synthetic circle and stream preparation."""

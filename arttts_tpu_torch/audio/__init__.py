"""Audio file IO."""

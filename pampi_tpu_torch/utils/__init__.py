"""Host utilities: .par parameters, output writers, flags, dtype and device policy."""

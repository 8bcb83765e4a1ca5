"""The fused visual-odometry tracker."""

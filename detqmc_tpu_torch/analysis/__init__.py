"""Offline analysis of run directories: the port's copies of the JAX
package's tools (deteval, tauint, jointimeseries, extractfrombinarystream,
sdwcorr, mrpt)."""

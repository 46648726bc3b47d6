"""Physics constants (recombination models, work functions).

Same physical constants as the reference (consts/physics.py:7-21); these are
fixed physics inputs, not detector configuration.
"""

#: Recombination alpha constant for the Box model (Baller 2013 JINST 8 P08005)
BOX_ALPHA = 0.93
#: Recombination beta for the Box model in (kV/cm)(g/cm^2)/MeV
BOX_BETA = 0.207
#: Recombination A_b for the Birks model (Amoruso et al NIM A 523 (2004) 275)
BIRKS_Ab = 0.800
#: Recombination k_b for the Birks model in (kV/cm)(g/cm^2)/MeV
BIRKS_kb = 0.0486
#: Electron charge in Coulomb
E_CHARGE = 1.602e-19
#: Average energy expended per ion pair in LAr, MeV (Phys. Rev. A 10, 1452)
W_ION = 23.6e-6

#: Recombination model selectors
BOX = 1
BIRKS = 2

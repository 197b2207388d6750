"""Central finite-difference stencils (validation mode for derivatives).

Same stencils as the reference (tuna_util.py:581-712).  Autodiff is the
primary derivative path; these remain for finite-field electric properties
and cross-checks.
"""


def first_derivative(F_m_1, F_p_1, dx):
    return (F_p_1 - F_m_1) / (2 * dx)


def second_derivative(F_m_2, F_m_1, F, F_p_1, F_p_2, dx):
    return (-F_m_2 + 16 * F_m_1 - 30 * F + 16 * F_p_1 - F_p_2) / (12 * dx**2)


def third_derivative(F_m_4, F_m_3, F_m_2, F_m_1, F_p_1, F_p_2, F_p_3, F_p_4, dx):
    return (-7 * F_m_4 + 72 * F_m_3 - 338 * F_m_2 + 488 * F_m_1
            - 488 * F_p_1 + 338 * F_p_2 - 72 * F_p_3 + 7 * F_p_4) / (240 * dx**3)


def fourth_derivative(F_m_4, F_m_3, F_m_2, F_m_1, F, F_p_1, F_p_2, F_p_3, F_p_4, dx):
    return (7 * F_m_4 - 96 * F_m_3 + 676 * F_m_2 - 1952 * F_m_1 + 2730 * F
            - 1952 * F_p_1 + 676 * F_p_2 - 96 * F_p_3 + 7 * F_p_4) / (240 * dx**4)

"""Few-shot chain-of-thought example banks for math benchmarks.

The port's own copy of ``evaluate/math_examples.py`` (same behaviour; imports resolve in this package).

Capability match for the reference's vendored example bank
(scripts/qwen_math_eval_toolkit/examples.py, 378 LoC): per-benchmark
few-shot prompts with worked solutions ending in boxed answers, exposed
through the same ``get_examples()`` shape (benchmark key → list of
(question, solution) pairs) at the reference's shot counts — gsm8k 8,
math 5, carp_en 8, mmlu_* 5, aqua/sat/minerva 4, PAL/ToRA program-aided
variants 3-5. All example content is fresh.
"""
from __future__ import annotations

# ----------------------------------------------------------------- gsm8k (8)

GSM8K = [
    ("A farm has 4 coops with 12 hens each. 9 hens are sold. How many hens "
     "are left?",
     "The farm starts with 4 * 12 = 48 hens. After selling 9, there are "
     "48 - 9 = 39 hens. The answer is $\\boxed{39}$."),
    ("Maya saves $15 a week for 6 weeks, then spends $32 on a gift. How much "
     "money does she have left?",
     "She saves 15 * 6 = 90 dollars. After the gift she has 90 - 32 = 58 "
     "dollars. The answer is $\\boxed{58}$."),
    ("A school bus makes 3 trips each morning carrying 28 students per trip. "
     "How many students does it carry in 5 mornings?",
     "Each morning it carries 3 * 28 = 84 students. Over 5 mornings that is "
     "84 * 5 = 420 students. The answer is $\\boxed{420}$."),
    ("Leo had 60 marbles. He gave a third of them to his sister and then "
     "bought 8 more. How many marbles does he have now?",
     "A third of 60 is 60 / 3 = 20, leaving 60 - 20 = 40. Buying 8 more "
     "gives 40 + 8 = 48. The answer is $\\boxed{48}$."),
    ("Tickets cost $9 for adults and $5 for children. A family buys 2 adult "
     "and 3 child tickets. How much do they pay?",
     "Adult tickets cost 2 * 9 = 18 dollars and child tickets 3 * 5 = 15 "
     "dollars. The total is 18 + 15 = 33 dollars. The answer is "
     "$\\boxed{33}$."),
    ("A tank holds 240 liters. A pump fills it at 15 liters per minute. "
     "After 8 minutes, how many liters are still needed to fill the tank?",
     "In 8 minutes the pump adds 15 * 8 = 120 liters. The tank still needs "
     "240 - 120 = 120 liters. The answer is $\\boxed{120}$."),
    ("Nina runs 4 km on weekdays and 10 km on each weekend day. How many km "
     "does she run in one week?",
     "Weekdays: 5 * 4 = 20 km. Weekend: 2 * 10 = 20 km. Total 20 + 20 = 40 "
     "km. The answer is $\\boxed{40}$."),
    ("A bakery sells muffins in packs of 6. It baked 13 dozen muffins. How "
     "many full packs can it sell?",
     "13 dozen is 13 * 12 = 156 muffins. That makes 156 / 6 = 26 full "
     "packs. The answer is $\\boxed{26}$."),
]

# ------------------------------------------------- gsm8k program-aided (3+3)

GSM8K_PAL = [
    ("A crate holds 18 apples. How many apples are in 7 crates after 11 are "
     "removed?",
     '```python\ndef solution():\n    """A crate holds 18 apples. How many '
     'apples are in 7 crates after 11 are removed?"""\n    crates = 7\n'
     "    apples_per_crate = 18\n    removed = 11\n    total = crates * "
     "apples_per_crate - removed\n    return total\n```"),
    ("Sam earns $12 an hour and worked 9 hours. He spent $40. How much does "
     "he have left?",
     '```python\ndef solution():\n    """Sam earns $12 an hour and worked 9 '
     'hours. He spent $40. How much does he have left?"""\n    wage = 12\n'
     "    hours = 9\n    spent = 40\n    left = wage * hours - spent\n"
     "    return left\n```"),
    ("A library had 230 books, lent out 75, and received 48 new ones. How "
     "many books does it have?",
     '```python\ndef solution():\n    """A library had 230 books, lent out '
     '75, and received 48 new ones. How many books does it have?"""\n'
     "    books = 230 - 75 + 48\n    return books\n```"),
]

GSM8K_TORA = [
    ("A crate holds 18 apples. How many apples are in 7 crates after 11 are "
     "removed?",
     "```python\ndef apples_left():\n    total = 7 * 18 - 11\n    return "
     "total\n\nprint(apples_left())\n```\n```output\n115\n```\nThere are "
     "$\\boxed{115}$ apples."),
    ("Sam earns $12 an hour and worked 9 hours. He spent $40. How much does "
     "he have left?",
     "```python\ndef money_left():\n    return 12 * 9 - 40\n\n"
     "print(money_left())\n```\n```output\n68\n```\nSam has $\\boxed{68}$ "
     "dollars left."),
    ("A library had 230 books, lent out 75, and received 48 new ones. How "
     "many books does it have?",
     "```python\ndef books_now():\n    return 230 - 75 + 48\n\n"
     "print(books_now())\n```\n```output\n203\n```\nThe library has "
     "$\\boxed{203}$ books."),
]

# ------------------------------------------------------------------ math (5)

MATH = [
    ("What is the sum of the roots of $x^2 - 7x + 10 = 0$?",
     "By Vieta's formulas the sum of the roots of $x^2 - 7x + 10$ is "
     "$-(-7)/1 = 7$. (Indeed the roots are 2 and 5.) The answer is "
     "$\\boxed{7}$."),
    ("Evaluate $\\binom{8}{3}$.",
     "$\\binom{8}{3} = \\frac{8!}{3!\\,5!} = \\frac{8 \\cdot 7 \\cdot 6}"
     "{6} = 56$. The answer is $\\boxed{56}$."),
    ("If $f(x) = 2x + 1$ and $g(x) = x^2$, what is $f(g(3))$?",
     "First $g(3) = 9$. Then $f(9) = 2 \\cdot 9 + 1 = 19$. The answer is "
     "$\\boxed{19}$."),
    ("A fair coin is flipped 4 times. What is the probability of exactly "
     "two heads?",
     "There are $2^4 = 16$ outcomes and $\\binom{4}{2} = 6$ with exactly "
     "two heads, so the probability is $6/16 = \\frac{3}{8}$. The answer "
     "is $\\boxed{\\frac{3}{8}}$."),
    ("Simplify $\\sqrt{75} + \\sqrt{27}$.",
     "$\\sqrt{75} = 5\\sqrt{3}$ and $\\sqrt{27} = 3\\sqrt{3}$, so the sum "
     "is $8\\sqrt{3}$. The answer is $\\boxed{8\\sqrt{3}}$."),
]

MATH_PAL = [
    ("Display the final result in LaTeX.\n\nFind the coefficient of $x^2$ "
     "in $(1 + 2x)^4$.",
     "```python\nfrom sympy import symbols, expand\n\ndef solution():\n"
     "    x = symbols('x')\n    expr = expand((1 + 2*x)**4)\n    result = "
     "expr.coeff(x, 2)\n    return result\n```"),
    ("Display the final result in LaTeX.\n\nCompute $\\gcd(462, 1071)$.",
     "```python\nfrom math import gcd\n\ndef solution():\n    return "
     "gcd(462, 1071)\n```"),
    ("Display the final result in LaTeX.\n\nWhat is the remainder when "
     "$7^{100}$ is divided by 5?",
     "```python\ndef solution():\n    return pow(7, 100, 5)\n```"),
    ("Display the final result in LaTeX.\n\nSolve $x^2 - 5x + 6 = 0$ and "
     "return the smaller root.",
     "```python\nfrom sympy import symbols, solve\n\ndef solution():\n"
     "    x = symbols('x')\n    roots = solve(x**2 - 5*x + 6, x)\n"
     "    return min(roots)\n```"),
]

MATH_TORA = [
    ("Compute $\\gcd(462, 1071)$.",
     "```python\nfrom math import gcd\n\nprint(gcd(462, 1071))\n```\n"
     "```output\n21\n```\nThe greatest common divisor is $\\boxed{21}$."),
    ("What is the remainder when $7^{100}$ is divided by 5?",
     "```python\nprint(pow(7, 100, 5))\n```\n```output\n1\n```\nSince "
     "$7^{100} \\equiv 2^{100} = (2^4)^{25} \\equiv 1 \\pmod 5$, the "
     "remainder is $\\boxed{1}$."),
    ("Find the coefficient of $x^2$ in $(1 + 2x)^4$.",
     "```python\nfrom sympy import symbols, expand\n\nx = symbols('x')\n"
     "print(expand((1 + 2*x)**4).coeff(x, 2))\n```\n```output\n24\n```\n"
     "The coefficient is $\\binom{4}{2} 2^2 = \\boxed{24}$."),
    ("Solve $x^2 - 5x + 6 = 0$; give the smaller root.",
     "```python\nfrom sympy import symbols, solve\n\nx = symbols('x')\n"
     "print(solve(x**2 - 5*x + 6, x))\n```\n```output\n[2, 3]\n```\nThe "
     "smaller root is $\\boxed{2}$."),
    ("Evaluate $\\sum_{k=1}^{100} k$.",
     "```python\nprint(sum(range(1, 101)))\n```\n```output\n5050\n```\n"
     "By the formula $n(n+1)/2 = 100 \\cdot 101 / 2$, the sum is "
     "$\\boxed{5050}$."),
]

# --------------------------------------------------------------- carp_en (8)

CARP_EN = [
    ("If $5a^{n+1}b^2$ and $-2a^3b^{m}$ are like terms, then $m + n = $?",
     "Like terms match exponents: $n + 1 = 3$ so $n = 2$, and $m = 2$. "
     "Thus $m + n = 4$. The answer is $\\boxed{4}$."),
    ("Factor: $x^2 - 9$.",
     "This is a difference of squares: $x^2 - 9 = (x-3)(x+3)$. The answer "
     "is $\\boxed{(x-3)(x+3)}$."),
    ("Solve the inequality $3x - 5 > 7$.",
     "Add 5: $3x > 12$; divide by 3: $x > 4$. The answer is "
     "$\\boxed{x > 4}$."),
    ("Compute $(2x^3)^2 \\cdot x$.",
     "$(2x^3)^2 = 4x^6$, and multiplying by $x$ gives $4x^7$. The answer "
     "is $\\boxed{4x^7}$."),
    ("If $x + \\frac{1}{x} = 3$, find $x^2 + \\frac{1}{x^2}$.",
     "Squaring: $x^2 + 2 + \\frac{1}{x^2} = 9$, so $x^2 + \\frac{1}{x^2} "
     "= 7$. The answer is $\\boxed{7}$."),
    ("The sum of the interior angles of a polygon is $1080^\\circ$. How "
     "many sides does it have?",
     "Interior angles sum to $(n-2) \\cdot 180^\\circ$, so $n - 2 = 6$ and "
     "$n = 8$. The answer is $\\boxed{8}$."),
    ("Solve the system: $x + y = 10$, $x - y = 4$.",
     "Adding gives $2x = 14$, so $x = 7$; then $y = 3$. The answer is "
     "$\\boxed{x=7, y=3}$."),
    ("Simplify $\\frac{x^2 - 4}{x + 2}$ for $x \\neq -2$.",
     "$x^2 - 4 = (x-2)(x+2)$; cancelling $x+2$ leaves $x - 2$. The answer "
     "is $\\boxed{x-2}$."),
]

# ---------------------------------------------------------- minerva_math (4)

MINERVA_MATH = [
    ("Find the domain of $\\frac{1}{\\sqrt{x - 3}}$.",
     "The radicand must be positive (it sits under a square root in a "
     "denominator): $x - 3 > 0$, i.e. $x > 3$. The answer is "
     "$\\boxed{(3, \\infty)}$."),
    ("Compute $\\lim_{x \\to 0} \\frac{\\sin 2x}{x}$.",
     "Using $\\sin u \\approx u$ near 0, $\\frac{\\sin 2x}{x} \\to "
     "\\frac{2x}{x} = 2$. The answer is $\\boxed{2}$."),
    ("What is $\\int_0^1 3x^2 \\, dx$?",
     "An antiderivative of $3x^2$ is $x^3$; evaluating from 0 to 1 gives "
     "$1 - 0 = 1$. The answer is $\\boxed{1}$."),
    ("A particle's position is $s(t) = t^3 - 6t$. What is its velocity at "
     "$t = 2$?",
     "Velocity is $s'(t) = 3t^2 - 6$; at $t = 2$, $s'(2) = 12 - 6 = 6$. "
     "The answer is $\\boxed{6}$."),
]

# ------------------------------------------------------------------ aqua (4)

AQUA = [
    ("The average of 5 numbers is 20. If one number 30 is removed, what is "
     "the average of the rest?\nAnswer Choices: (A) 16.5 (B) 17.5 (C) 18 "
     "(D) 19 (E) 20",
     "The five numbers sum to 100. Removing 30 leaves 70 over 4 numbers: "
     "70 / 4 = 17.5. The answer is $\\boxed{B}$."),
    ("A train travels 180 km in 3 hours. At the same speed, how long does "
     "240 km take?\nAnswer Choices: (A) 3.5 hours (B) 4 hours (C) 4.5 "
     "hours (D) 5 hours (E) 6 hours",
     "Speed is 180 / 3 = 60 km/h, so 240 km takes 240 / 60 = 4 hours. The "
     "answer is $\\boxed{B}$."),
    ("If 3 pencils cost 45 cents, how much do 10 pencils cost?\nAnswer "
     "Choices: (A) 120 cents (B) 135 cents (C) 150 cents (D) 160 cents "
     "(E) 180 cents",
     "Each pencil costs 45 / 3 = 15 cents, so 10 cost 150 cents. The "
     "answer is $\\boxed{C}$."),
    ("What is 40% of 250?\nAnswer Choices: (A) 80 (B) 90 (C) 100 (D) 110 "
     "(E) 120",
     "40% of 250 is 0.4 * 250 = 100. The answer is $\\boxed{C}$."),
]

# -------------------------------------------------------------- sat_math (4)

SAT_MATH = [
    ("If $\\frac{x+2}{5}=k$ and $k=4$, what is the value of $x$?\nAnswer "
     "Choices: (A) 14 (B) 16 (C) 18 (D) 22",
     "From $\\frac{x+2}{5} = 4$ we get $x + 2 = 20$, so $x = 18$. The "
     "answer is $\\boxed{C}$."),
    ("A line passes through $(0, 3)$ with slope 2. What is $y$ when "
     "$x = 4$?\nAnswer Choices: (A) 8 (B) 9 (C) 10 (D) 11",
     "The line is $y = 2x + 3$; at $x = 4$, $y = 11$. The answer is "
     "$\\boxed{D}$."),
    ("If $3(x - 2) = 2x + 5$, what is $x$?\nAnswer Choices: (A) 7 (B) 9 "
     "(C) 11 (D) 13",
     "Expanding: $3x - 6 = 2x + 5$, so $x = 11$. The answer is "
     "$\\boxed{C}$."),
    ("The function $f$ is defined by $f(x) = x^2 - 2x$. What is $f(5)$?\n"
     "Answer Choices: (A) 10 (B) 15 (C) 20 (D) 25",
     "$f(5) = 25 - 10 = 15$. The answer is $\\boxed{B}$."),
]

# ----------------------------------------------------------------- mmlu (5×)

MMLU_MATHEMATICS = [
    ("What is the units digit of $7^{4}$?\nAnswer Choices: (A) 1 (B) 3 "
     "(C) 7 (D) 9",
     "$7^2 = 49$ ends in 9; $7^4 = (7^2)^2$ ends in $9^2 = 81$'s units "
     "digit, 1. The answer is $\\boxed{A}$."),
    ("How many subsets does a set with 5 elements have?\nAnswer Choices: "
     "(A) 10 (B) 25 (C) 32 (D) 64",
     "A set with $n$ elements has $2^n$ subsets; $2^5 = 32$. The answer "
     "is $\\boxed{C}$."),
    ("What is the solution of $2^x = 16$?\nAnswer Choices: (A) 2 (B) 3 "
     "(C) 4 (D) 8",
     "$16 = 2^4$, so $x = 4$. The answer is $\\boxed{C}$."),
    ("The determinant of $\\begin{pmatrix} 2 & 1 \\\\ 3 & 4 "
     "\\end{pmatrix}$ is:\nAnswer Choices: (A) 5 (B) 8 (C) 11 (D) -5",
     "$2 \\cdot 4 - 1 \\cdot 3 = 8 - 3 = 5$. The answer is $\\boxed{A}$."),
    ("What is $\\frac{d}{dx} \\ln(x^2)$ for $x > 0$?\nAnswer Choices: "
     "(A) $1/x^2$ (B) $2/x$ (C) $x/2$ (D) $2x$",
     "$\\ln(x^2) = 2 \\ln x$, whose derivative is $2/x$. The answer is "
     "$\\boxed{B}$."),
]

MMLU_PHYSICS = [
    ("A 2 kg mass accelerates at 3 m/s². What net force acts on it?\n"
     "Answer Choices: (A) 1.5 N (B) 5 N (C) 6 N (D) 9 N",
     "Newton's second law: $F = ma = 2 \\cdot 3 = 6$ N. The answer is "
     "$\\boxed{C}$."),
    ("A 120 V appliance draws 3 A. What is its power?\nAnswer Choices: "
     "(A) 40 W (B) 123 W (C) 240 W (D) 360 W",
     "$P = VI = 120 \\cdot 3 = 360$ W. The answer is $\\boxed{D}$."),
    ("Light in vacuum travels at about:\nAnswer Choices: (A) 3×10⁶ m/s "
     "(B) 3×10⁸ m/s (C) 3×10¹⁰ m/s (D) 3×10¹² m/s",
     "The speed of light in vacuum is approximately $3 \\times 10^8$ m/s. "
     "The answer is $\\boxed{B}$."),
    ("A ball is dropped from rest. Ignoring air resistance, its speed "
     "after 2 s is about:\nAnswer Choices: (A) 5 m/s (B) 10 m/s (C) 20 "
     "m/s (D) 40 m/s",
     "$v = gt \\approx 9.8 \\cdot 2 \\approx 20$ m/s. The answer is "
     "$\\boxed{C}$."),
    ("Doubling the distance between two point charges changes the force "
     "between them by a factor of:\nAnswer Choices: (A) 1/2 (B) 1/4 "
     "(C) 2 (D) 4",
     "Coulomb's law scales as $1/r^2$; doubling $r$ quarters the force. "
     "The answer is $\\boxed{B}$."),
]

MMLU_CHEMISTRY = [
    ("What is the pH of a 0.01 M HCl solution (complete dissociation)?\n"
     "Answer Choices: (A) 1 (B) 2 (C) 3 (D) 4",
     "$[H^+] = 10^{-2}$ M, so pH $= -\\log_{10} 10^{-2} = 2$. The answer "
     "is $\\boxed{B}$."),
    ("How many moles are in 44 g of CO₂ (molar mass 44 g/mol)?\nAnswer "
     "Choices: (A) 0.5 (B) 1 (C) 2 (D) 44",
     "$n = m/M = 44/44 = 1$ mole. The answer is $\\boxed{B}$."),
    ("Which element has the electron configuration 1s² 2s² 2p⁶ 3s¹?\n"
     "Answer Choices: (A) Neon (B) Sodium (C) Magnesium (D) Potassium",
     "Eleven electrons total → atomic number 11, sodium. The answer is "
     "$\\boxed{B}$."),
    ("In the reaction 2H₂ + O₂ → 2H₂O, how many moles of water form from "
     "3 moles of O₂ (excess H₂)?\nAnswer Choices: (A) 2 (B) 3 (C) 4 "
     "(D) 6",
     "The ratio of H₂O to O₂ is 2:1, so 3 moles of O₂ give 6 moles of "
     "water. The answer is $\\boxed{D}$."),
    ("Which bond is most polar?\nAnswer Choices: (A) C–H (B) C–C (C) H–F "
     "(D) O–O",
     "H–F has the largest electronegativity difference of the options. "
     "The answer is $\\boxed{C}$."),
]

MMLU_BIOLOGY = [
    ("Which organelle produces most of a cell's ATP?\nAnswer Choices: "
     "(A) Nucleus (B) Ribosome (C) Mitochondrion (D) Golgi apparatus",
     "Oxidative phosphorylation in mitochondria supplies most ATP. The "
     "answer is $\\boxed{C}$."),
    ("DNA replication is described as:\nAnswer Choices: (A) conservative "
     "(B) semiconservative (C) dispersive (D) random",
     "Each daughter duplex keeps one parental strand — semiconservative "
     "(Meselson–Stahl). The answer is $\\boxed{B}$."),
    ("In pea plants, tall (T) is dominant over short (t). A Tt × Tt cross "
     "gives what fraction of short plants?\nAnswer Choices: (A) 0 (B) 1/4 "
     "(C) 1/2 (D) 3/4",
     "Offspring genotypes are 1 TT : 2 Tt : 1 tt; only tt (1/4) is "
     "short. The answer is $\\boxed{B}$."),
    ("Which process directly produces mRNA from a DNA template?\nAnswer "
     "Choices: (A) Translation (B) Transcription (C) Replication "
     "(D) Splicing",
     "RNA polymerase transcribes DNA into mRNA. The answer is "
     "$\\boxed{B}$."),
    ("Secreted proteins travel through which pathway?\nAnswer Choices: "
     "(A) ER → Golgi → vesicle → membrane (B) Golgi → ER → membrane "
     "(C) nucleus → lysosome (D) cytosol → mitochondrion",
     "The secretory pathway runs rough ER → Golgi → secretory vesicles → "
     "plasma membrane. The answer is $\\boxed{A}$."),
]

MMLU_COMPUTER = [
    ("What is the binary representation of decimal 13?\nAnswer Choices: "
     "(A) 1011 (B) 1101 (C) 1110 (D) 1001",
     "$13 = 8 + 4 + 1 = 1101_2$. The answer is $\\boxed{B}$."),
    ("Binary search on a sorted array of n elements runs in:\nAnswer "
     "Choices: (A) O(1) (B) O(log n) (C) O(n) (D) O(n log n)",
     "Each probe halves the search interval → $O(\\log n)$. The answer "
     "is $\\boxed{B}$."),
    ("Which data structure is FIFO?\nAnswer Choices: (A) Stack (B) Queue "
     "(C) Tree (D) Hash table",
     "A queue serves items first-in-first-out. The answer is "
     "$\\boxed{B}$."),
    ("How many distinct values can one byte represent?\nAnswer Choices: "
     "(A) 128 (B) 255 (C) 256 (D) 512",
     "A byte has 8 bits → $2^8 = 256$ values. The answer is "
     "$\\boxed{C}$."),
    ("Which of these is an example of an Internet of Things device?\n"
     "Answer Choices: (A) a smart thermostat reporting to the cloud "
     "(B) an offline calculator (C) a printed book (D) a wall clock",
     "A cloud-connected smart thermostat is a networked sensor device. "
     "The answer is $\\boxed{A}$."),
]

# ---------------------------------------------------------------- gaokao (5)

GAOKAO = [
    ("已知集合 $A = \\{1, 2, 3\\}$, $B = \\{2, 3, 4\\}$, 求 $A \\cap B$。",
     "两集合的公共元素为 2 和 3，所以 $A \\cap B = \\{2, 3\\}$。答案是 "
     "$\\boxed{\\{2, 3\\}}$。"),
    ("设等差数列 $\\{a_n\\}$ 满足 $a_1 = 2$, 公差 $d = 3$, 求 $a_5$。",
     "$a_5 = a_1 + 4d = 2 + 12 = 14$。答案是 $\\boxed{14}$。"),
    ("若 $\\sin\\theta = \\frac{3}{5}$ 且 $\\theta$ 为锐角, 求 "
     "$\\cos\\theta$。",
     "由 $\\sin^2\\theta + \\cos^2\\theta = 1$ 得 $\\cos\\theta = "
     "\\sqrt{1 - 9/25} = \\frac{4}{5}$（锐角取正）。答案是 "
     "$\\boxed{\\frac{4}{5}}$。"),
    ("求函数 $f(x) = x^2 - 4x + 7$ 的最小值。",
     "配方得 $f(x) = (x-2)^2 + 3$，当 $x = 2$ 时取最小值 3。答案是 "
     "$\\boxed{3}$。"),
    ("从 5 名同学中选 2 名参加比赛, 共有多少种选法?",
     "组合数 $\\binom{5}{2} = 10$。答案是 $\\boxed{10}$。"),
]

# ------------------------------------------------------------------- banks

EXAMPLE_SETS: dict[str, list[tuple[str, str]]] = {
    "gsm8k": GSM8K,
    "gsm8k-pal": GSM8K_PAL,
    "gsm8k-tora": GSM8K_TORA,
    "math": MATH,
    "math_pal": MATH_PAL,
    "math-tora": MATH_TORA,
    "carp_en": CARP_EN,
    "minerva_math": MINERVA_MATH,
    "aqua": AQUA,
    "sat_math": SAT_MATH,
    "mmlu_mathematics": MMLU_MATHEMATICS,
    "mmlu_physics": MMLU_PHYSICS,
    "mmlu_chemistry": MMLU_CHEMISTRY,
    "mmlu_biology": MMLU_BIOLOGY,
    "mmlu_computer": MMLU_COMPUTER,
    "mmlu_stem": MMLU_MATHEMATICS,
    "gaokao": GAOKAO,
}


def get_examples() -> dict[str, list[tuple[str, str]]]:
    """Benchmark key → list of (question, solution) pairs (the reference's
    access shape, scripts/qwen_math_eval_toolkit/examples.py:4)."""
    return dict(EXAMPLE_SETS)


# backward-compatible aliases (r1/r2 shape: list of dicts)
MATH_EXAMPLES = [{"question": q, "solution": s} for q, s in MATH]
GSM8K_EXAMPLES = [{"question": q, "solution": s} for q, s in GSM8K]


def build_few_shot_prompt(question: str, benchmark: str = "math",
                          n_shots: int | None = None) -> str:
    """Render a few-shot CoT prompt ending with the target question.

    ``n_shots=None`` uses the benchmark's full bank (the reference's shot
    counts); pass a smaller number to truncate.
    """
    bank = EXAMPLE_SETS.get(benchmark, MATH)
    shots = bank if n_shots is None else bank[:n_shots]
    parts = []
    for q, s in shots:
        parts.append(f"Question: {q}\nSolution: {s}\n")
    parts.append(f"Question: {question}\nSolution:")
    return "\n".join(parts)
